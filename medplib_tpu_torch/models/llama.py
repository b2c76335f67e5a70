"""Dense LLaMA decoder (medplib_tpu/models/llama.py) in plain PyTorch.

Params are nested dicts with the JAX key paths and layouts: per-layer
tensors stacked on a leading [L] axis, q/k/v kernels stored [out, in], the
rest [in, out]. A layer's view (`layer_params`) is free in torch, so the
layer stack is a Python loop.

The MLP is pluggable (`mlp_apply(layer_params, h) -> (y, aux)`): the MoE
variant (models/moe_llama.py) reuses these blocks.

Packed trees (`pack_inference`): q/k/v fuse into one transposed
`qkv_proj` and gate/up into one `gateup_proj`; an int8 packed kernel runs
on K7 (ops/cuda/int8_matmul), an int4h one on K9 (ops/cuda/int4_matmul),
a float one on the LoRA linear.

Tensor parallelism (parallel/tp.py): under a mesh with a model axis the
layers run on the rank's heads and MLP block (`tp.local_cfg`), q / k / v
and gate / up column-parallel, o / down row-parallel with a sum over
`model`, the embedding and lm_head split on the vocabulary; the cache holds
the rank's heads.

KV cache: prefill, decode and the chunked-prefill extend write the cache
IN PLACE (the JAX package returns a new cache), so a decode loop never
copies it. With quant=True it holds int8 k / v and f32
per-token-per-head scales (ops/attention.py quantize_kv,
decode_attention_quant).

Training: `forward(..., remat=True)` runs each decoder layer under
torch.utils.checkpoint (the counterpart of jax.checkpoint on the scan
body): only the layer inputs stay alive, and each layer is recomputed in
the backward. A layer re-enters the caller's LoRA-dropout and W8A8 state
explicitly, so its recompute sees what its forward saw.

The layer bodies take their attention as they take their MLP: an
Attention (rope tables, prefill form, decode form over the layer's cache
view) chosen once per config by attention_for. An MlaConfig (DeepSeek-V2)
gets models/mla.py's (the expanded form at prefill, the absorbed form at
decode) over an mla.LatentCache, with the caller's MLP
(models/deepseek_v2.py); the chunked-prefill extend, the int8 cache and
tensor parallelism do not cover it and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from medplib_tpu_torch.config import LlamaConfig, is_mla
from medplib_tpu_torch.models import mla
from medplib_tpu_torch.ops.activations import silu
from medplib_tpu_torch.ops.attention import (causal_attention,
                                             decode_attention,
                                             decode_attention_quant,
                                             extend_attention,
                                             extend_attention_quant,
                                             quantize_kv)
from medplib_tpu_torch.ops.initializers import dense_init, embed_init
from medplib_tpu_torch.ops.norms import rms_norm
from medplib_tpu_torch.ops.rope import (apply_rope, mla_rope_cos_sin,
                                        rope_cos_sin)
from medplib_tpu_torch.parallel import tp
from medplib_tpu_torch.train import lora
from medplib_tpu_torch.train.lora import linear, linear_t
from medplib_tpu_torch.utils import profiling
from medplib_tpu_torch.utils.quantize import (act_quant_enabled,
                                              dynamic_act_quant)

Params = Dict[str, Any]


@dataclass
class KVCache:
    """k/v [L, B, MAX, KV_HEADS, D]; length [B] int32 (valid entries).
    Quantized (`quant=True`): k/v int8 and k_scale/v_scale
    [L, B, MAX, KV_HEADS, 1] f32 absmax / 127 scales."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, max_len: int,
             dtype=torch.bfloat16, device="cuda",
             quant: bool = False) -> "KVCache":
        if is_mla(cfg):
            raise ValueError("an MLA configuration caches latents: "
                             "models/mla.LatentCache, not KVCache")
        cfg = tp.local_cfg(cfg)        # a model rank caches its heads
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        zeros = lambda s, dt: torch.zeros(s, dtype=dt,  # noqa: E731
                                          device=device)
        length = zeros((batch,), torch.int32)
        if quant:
            sshape = shape[:-1] + (1,)
            return KVCache(k=zeros(shape, torch.int8),
                           v=zeros(shape, torch.int8), length=length,
                           k_scale=zeros(sshape, torch.float32),
                           v_scale=zeros(sshape, torch.float32))
        return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype),
                       length=length)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def layer(self, i: int):
        """Layer i's views (k, v, k_scale, v_scale), the scales None
        unless quantized: what LLAMA_ATTENTION's forms write."""
        if self.quantized:
            return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]
        return self.k[i], self.v[i], None, None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: LlamaConfig, dtype, device, lead=()) -> Params:
    h, m = cfg.hidden_size, cfg.intermediate_size
    return {"gate_proj": {"kernel": dense_init(gen, h, m, dtype, device,
                                               lead)},
            "up_proj": {"kernel": dense_init(gen, h, m, dtype, device, lead)},
            "down_proj": {"kernel": dense_init(gen, m, h, dtype, device,
                                               lead)}}


def init_llama(gen: torch.Generator, cfg: LlamaConfig, dtype=torch.float32,
               vocab_size: Optional[int] = None, device="cuda") -> Params:
    """Random params with the stacked [L, ...] layout."""
    vocab = vocab_size or cfg.vocab_size
    h, L = cfg.hidden_size, cfg.num_layers
    q_dim, kv_dim = cfg.num_heads * cfg.head_dim, \
        cfg.num_kv_heads * cfg.head_dim
    t = lambda a: a.transpose(-1, -2).contiguous()  # noqa: E731 [out, in]
    layers = {
        "input_layernorm": {"weight": torch.ones((L, h), dtype=dtype,
                                                 device=device)},
        "attn": {
            "q_proj": {"kernel": t(dense_init(gen, h, q_dim, dtype, device,
                                              (L,)))},
            "k_proj": {"kernel": t(dense_init(gen, h, kv_dim, dtype, device,
                                              (L,)))},
            "v_proj": {"kernel": t(dense_init(gen, h, kv_dim, dtype, device,
                                              (L,)))},
            "o_proj": {"kernel": dense_init(gen, q_dim, h, dtype, device,
                                            (L,))},
        },
        "post_attention_layernorm": {"weight": torch.ones(
            (L, h), dtype=dtype, device=device)},
        "mlp": init_mlp(gen, cfg, dtype, device, (L,)),
    }
    return {
        "embed_tokens": {"embedding": embed_init(gen, vocab, h, dtype,
                                                 device)},
        "layers": layers,
        "norm": {"weight": torch.ones((h,), dtype=dtype, device=device)},
        "lm_head": {"kernel": dense_init(gen, h, vocab, dtype, device)},
    }


def layer_params(tree: Any, i: int) -> Any:
    """Layer i's view of a stacked [L, ...] subtree (no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _packed_linear(p: Params, x: torch.Tensor, transposed: bool):
    """A pack_inference kernel: int8 -> K7, int4h -> K9, float -> the LoRA
    linear. Packed kernels never take W8A8 (as in the JAX package)."""
    if "scale" in p and p["kernel"].dtype == torch.int8:
        from medplib_tpu_torch.ops.cuda import int8_matmul as K7
        fn = K7.int8_matmul_t if transposed else K7.int8_matmul
        return fn(x, p["kernel"], p["scale"])
    if "scale4h" in p:
        from medplib_tpu_torch.ops.cuda import int4_matmul as K9
        fn = K9.int4h_matmul_t if transposed else K9.int4h_matmul
        return fn(x, p["kernel"], p["scale4h"])
    return linear_t(p, x) if transposed else linear(p, x)


def dense_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x)); one wide gate-up product on a
    packed tree. Under tensor parallelism gate / up give the rank's block
    of the intermediate and down sums the blocks' products."""
    if "gateup_proj" in p:
        node = p["gateup_proj"]
        half = node["kernel"].shape[-1] // 2
        node = tp.packed_local(node, (half, half), False)
        gate, up = _packed_linear(node, x, False).chunk(2, -1)
    else:
        gate = tp.column_linear(p["gate_proj"], x)
        up = tp.column_linear(p["up_proj"], x)
    return tp.row_linear(p["down_proj"], silu(gate) * up)


def dense_mlp_layer(layer_p: Params, x: torch.Tensor):
    return dense_mlp(layer_p["mlp"], x), torch.zeros((), device=x.device)


MlpApply = Callable[[Params, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _qkv(p: Params, x: torch.Tensor, cfg: LlamaConfig, cos, sin):
    b, t, _ = x.shape
    qd = cfg.num_heads * cfg.head_dim
    kd = cfg.num_kv_heads * cfg.head_dim
    if "qkv_proj" in p:        # packed: one wide product, split on columns
        node = p["qkv_proj"]
        if tp.model_axis() is not None:   # cfg is the rank's (local_cfg)
            m = tp.model_axis()[1]
            node = tp.packed_local(node, (qd * m, kd * m, kd * m), True)
        q, k, v = _packed_linear(node, x, True).split([qd, kd, kd], dim=-1)
    else:
        q, k, v = (tp.column_linear(p[n], x, transposed=True)
                   for n in ("q_proj", "k_proj", "v_proj"))
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _prefill_attention(p: Params, h: torch.Tensor, cfg: LlamaConfig, cos,
                       sin, attn_mask: Optional[torch.Tensor],
                       view=None) -> torch.Tensor:
    """q / k / v, causal attention, o_proj -> [B, T, hidden]; K/V written
    at positions [0, T) of the layer's cache view (KVCache.layer) when
    given."""
    b, t = h.shape[:2]
    q, k, v = _qkv(p["attn"], h, cfg, cos, sin)
    if view is not None:
        k_cache, v_cache, k_scale, v_scale = view
        if k_scale is not None:
            k_cache[:, :t], k_scale[:, :t] = quantize_kv(k)
            v_cache[:, :t], v_scale[:, :t] = quantize_kv(v)
        else:
            k_cache[:, :t] = k.to(k_cache.dtype)
            v_cache[:, :t] = v.to(v_cache.dtype)
    attn = causal_attention(q, k, v, attn_mask)
    return tp.row_linear(p["attn"]["o_proj"], attn.reshape(b, t, -1))


def _decode_attention(p: Params, h: torch.Tensor, cfg: LlamaConfig, cos,
                      sin, view, length: torch.Tensor) -> torch.Tensor:
    """One token a row against the layer's cache view (KVCache.layer):
    writes its k/v at row position `length` (in place; quantized with
    their scales in an int8 cache) and attends to the first length + 1.
    -> o_proj's output [B, 1, hidden].

    A row whose length has reached the cache's size writes nothing, as
    JAX's scatter drops an out-of-bounds update: an idle serving slot keeps
    decoding past its cache (serve/engine.py). Such a row writes back the
    value already at its clamped position, so no host sync is needed."""
    k_cache, v_cache, k_scale, v_scale = view
    q, k, v = _qkv(p["attn"], h, cfg, cos, sin)
    b = h.shape[0]
    bidx = torch.arange(b, device=h.device)
    pos = length.long()
    ok = pos < k_cache.shape[1]
    pos = pos.clamp(max=k_cache.shape[1] - 1)

    def put(cache, new):
        keep = ok.reshape((b,) + (1,) * (new.dim() - 1))
        cache[bidx, pos] = torch.where(keep, new.to(cache.dtype),
                                       cache[bidx, pos])

    if k_scale is not None:
        kq, ksc = quantize_kv(k[:, 0])
        vq, vsc = quantize_kv(v[:, 0])
        for cache, new in ((k_cache, kq), (k_scale, ksc), (v_cache, vq),
                           (v_scale, vsc)):
            put(cache, new)
        attn = decode_attention_quant(q, k_cache, k_scale, v_cache,
                                      v_scale, length + 1)
    else:
        put(k_cache, k[:, 0])
        put(v_cache, v[:, 0])
        attn = decode_attention(q, k_cache, v_cache, length + 1)
    return tp.row_linear(p["attn"]["o_proj"], attn.reshape(b, 1, -1))


def _mla_rope(positions: torch.Tensor, cfg):
    if tp.model_axis() is not None:
        raise NotImplementedError("MLA under tensor parallelism")
    return mla_rope_cos_sin(positions, cfg)


class Attention(NamedTuple):
    """One kind of attention of the layer loops, chosen once per config
    (attention_for), as mlp_apply is per model. Each form takes the
    layer's params (with "layer_idx") and the normed input, and writes
    the layer's cache view (`cache.layer(i)`) in place."""

    rope: Callable      # (positions, cfg) -> (cos, sin)
    prefill: Callable   # (p, h, cfg, cos, sin, attn_mask, view) -> out
    decode: Callable    # (p, h, cfg, cos, sin, view, length) -> out


LLAMA_ATTENTION = Attention(
    lambda positions, cfg: rope_cos_sin(positions, cfg.head_dim,
                                        cfg.rope_theta),
    _prefill_attention, _decode_attention)
# MLA (models/mla.py): the expanded form at prefill, the absorbed form at
# decode, over a LatentCache
MLA_ATTENTION = Attention(
    _mla_rope,
    lambda p, *a: mla.prefill_attention(p["attn"], *a),
    lambda p, *a: mla.decode_attention(p["attn"], *a))


def attention_for(cfg: LlamaConfig) -> Attention:
    return MLA_ATTENTION if is_mla(cfg) else LLAMA_ATTENTION


def decoder_layer_prefill(p: Params, x: torch.Tensor, cfg: LlamaConfig,
                          cos, sin, attn_mask: Optional[torch.Tensor],
                          mlp_apply: MlpApply, attend: Callable,
                          view=None):
    """-> (x', aux). attend: an Attention's prefill form; view: the
    layer's cache view, written in place, or None."""
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    with profiling.span("attn"):
        x = x + attend(p, h, cfg, cos, sin, attn_mask, view)
    h = rms_norm(x, p["post_attention_layernorm"]["weight"],
                 cfg.rms_norm_eps)
    y, aux = mlp_apply(p, h)
    return x + y, aux


def decoder_layer_decode(p: Params, x: torch.Tensor, cfg: LlamaConfig,
                         cos, sin, view, length: torch.Tensor,
                         mlp_apply: MlpApply, attend: Callable
                         ) -> torch.Tensor:
    """x [B, 1, H] -> x'. attend: an Attention's decode form, which writes
    this token into the layer's cache view at row position `length` and
    attends to the first length + 1."""
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    with profiling.span("attn"):
        x = x + attend(p, h, cfg, cos, sin, view, length)
    h = rms_norm(x, p["post_attention_layernorm"]["weight"],
                 cfg.rms_norm_eps)
    y, _ = mlp_apply(p, h)
    return x + y


def forward(params: Params, cfg: LlamaConfig, input_embeds: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            mlp_apply: MlpApply = dense_mlp_layer,
            cache: Optional[KVCache] = None, remat: bool = False):
    """Prefill over the layer stack. input_embeds [B, T, H].
    -> (hidden_post_norm [B, T, H], cache|None, aux_loss). With a cache,
    K/V (an MLA config's latents) land at positions [0, T) and
    cache.length is set from the attn_mask row sums (left-aligned
    sequences). remat: checkpoint each layer (training; no cache)."""
    if remat and cache is not None:
        raise ValueError("remat is for training, without a KV cache")
    cfg = tp.local_cfg(cfg)
    b, t, _ = input_embeds.shape
    dev = input_embeds.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    attn = attention_for(cfg)
    cos, sin = attn.rope(positions, cfg)
    drop, act_quant = lora.dropout_state(), act_quant_enabled()

    def layer(i, x):
        with lora.dropout_scope(drop, i), dynamic_act_quant(act_quant):
            return decoder_layer_prefill(
                dict(layer_params(params["layers"], i), layer_idx=i), x, cfg,
                cos, sin, attn_mask, mlp_apply, attn.prefill,
                None if cache is None else cache.layer(i))

    x = input_embeds
    aux = torch.zeros((), device=dev)
    for i in range(cfg.num_layers):
        with profiling.span("llm.layer", layer=i):
            if remat:
                x, a = checkpoint(layer, i, x, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = layer(i, x)
            aux = aux + a
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    if cache is not None:
        cache.length = (attn_mask.int().sum(-1).to(torch.int32)
                        if attn_mask is not None else
                        torch.full((b,), t, dtype=torch.int32, device=dev))
    return x, cache, aux


def forward_decode(params: Params, cfg: LlamaConfig,
                   input_embeds: torch.Tensor, cache: KVCache,
                   mlp_apply: MlpApply = dense_mlp_layer):
    """One decode step. input_embeds [B, 1, H] -> (hidden [B, 1, H],
    cache with length + 1; K/V (latents) written in place)."""
    cfg = tp.local_cfg(cfg)
    attn = attention_for(cfg)
    cos, sin = attn.rope(cache.length[:, None], cfg)
    x = input_embeds
    for i in range(cfg.num_layers):
        with profiling.span("llm.layer", layer=i):
            x = decoder_layer_decode(
                dict(layer_params(params["layers"], i), layer_idx=i), x, cfg,
                cos, sin, cache.layer(i), cache.length, mlp_apply,
                attn.decode)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    cache.length = cache.length + 1
    return x, cache


def forward_extend(params: Params, cfg: LlamaConfig,
                   input_embeds: torch.Tensor, cache: KVCache, c0,
                   mlp_apply: MlpApply = dense_mlp_layer):
    """Chunked-prefill extend: input_embeds [B, C, H] are the prompt
    tokens at absolute positions [c0, c0 + C) (c0 a Python int or a 0-d
    tensor). Each layer writes their K/V into [c0, c0 + C) of its cache
    view in place (int8 values and scales for a quantized cache) and
    attends each query causally to everything written so far.
    cache.length is NOT advanced: the caller sets it from the prompt mask
    after the last chunk (medplib.stream_prefill_finish).
    -> (hidden_post_norm [B, C, H], cache)."""
    if is_mla(cfg):
        raise NotImplementedError(
            "chunked prefill (forward_extend, the engine's path) does not "
            "cover MLA: serve an MLA configuration through "
            "medplib.generate / stream_prefill")
    cfg = tp.local_cfg(cfg)
    b, c, _ = input_embeds.shape
    c0 = int(c0)
    if c0 < 0 or c0 + c > cache.k.shape[2]:
        raise ValueError(f"extend chunk [{c0}, {c0 + c}) does not fit the "
                         f"cache of {cache.k.shape[2]} positions")
    dev = input_embeds.device
    positions = (c0 + torch.arange(c, device=dev))[None].expand(b, c)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    x = input_embeds
    span = slice(c0, c0 + c)
    for i in range(cfg.num_layers):
        with profiling.span("llm.layer", layer=i):
            x = _extend_layer(layer_params(params["layers"], i), i, x, cfg,
                              cos, sin, cache, span, mlp_apply)
    x = rms_norm(x, params["norm"]["weight"], cfg.rms_norm_eps)
    return x, cache


def _extend_layer(p: Params, i: int, x, cfg: LlamaConfig, cos, sin,
                  cache: KVCache, span: slice, mlp_apply: MlpApply):
    """Layer i of forward_extend over the prompt positions `span`."""
    b, c = x.shape[:2]
    h = rms_norm(x, p["input_layernorm"]["weight"], cfg.rms_norm_eps)
    with profiling.span("attn"):
        q, k, v = _qkv(p["attn"], h, cfg, cos, sin)
        if cache.quantized:
            cache.k[i, :, span], cache.k_scale[i, :, span] = quantize_kv(k)
            cache.v[i, :, span], cache.v_scale[i, :, span] = quantize_kv(v)
            attn = extend_attention_quant(q, cache.k[i], cache.k_scale[i],
                                          cache.v[i], cache.v_scale[i],
                                          span.start)
        else:
            cache.k[i, :, span] = k.to(cache.k.dtype)
            cache.v[i, :, span] = v.to(cache.v.dtype)
            attn = extend_attention(q.to(cache.k.dtype), cache.k[i],
                                    cache.v[i], span.start)
        x = x + tp.row_linear(p["attn"]["o_proj"],
                              attn.to(x.dtype).reshape(b, c, -1))
    h = rms_norm(x, p["post_attention_layernorm"]["weight"],
                 cfg.rms_norm_eps)
    y, _ = mlp_apply(p, h)
    return x + y


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings; negative sentinel ids clamp to 0 (their
    slots are overwritten by the splice)."""
    return tp.embed(params["embed_tokens"]["embedding"],
                    input_ids.clamp(min=0).long())


def logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits over the whole vocabulary (all-gathered from the model
    ranks' blocks under tensor parallelism)."""
    with profiling.span("lm_head"):
        return tp.gather_vocab(tp.column_linear(params["lm_head"],
                                                hidden).float())


def pack_inference(llm_params: Params) -> Params:
    """Inference packing: q/k/v fuse into one transposed `qkv_proj`
    [L, 3H, H] kernel (concatenated on the out axis) and gate/up into one
    `gateup_proj` [L, H, 2I] (on the last axis), so each layer runs one
    wide product for each. LoRA must be merged first (train/lora.merge) and
    quantization comes after (utils/quantize.quantize_tree). MUTATES
    llm_params: the source kernels are popped, so their memory is freed."""
    attn = llm_params["layers"]["attn"]
    if all(k in attn for k in ("q_proj", "k_proj", "v_proj")):
        for name in ("q_proj", "k_proj", "v_proj"):
            if "lora_a" in attn[name]:
                raise ValueError("merge LoRA before pack_inference")
            if "scale" in attn[name] or "scale4" in attn[name]:
                raise ValueError("pack_inference must run BEFORE "
                                 "quantize_tree (per-channel scales can't "
                                 "be concatenated post hoc)")
        ks = [attn.pop(n)["kernel"] for n in ("q_proj", "k_proj", "v_proj")]
        attn["qkv_proj"] = {"kernel": torch.cat(ks, dim=ks[0].dim() - 2)}
        del ks
    mlp = llm_params["layers"].get("mlp")
    if mlp is not None and "gate_proj" in mlp:
        if "lora_a" in mlp["gate_proj"] or "lora_a" in mlp["up_proj"]:
            raise ValueError("merge LoRA before pack_inference")
        if any(s in mlp[n] for s in ("scale", "scale4")
               for n in ("gate_proj", "up_proj")):
            raise ValueError("pack_inference must run BEFORE quantize_tree")
        ks = [mlp.pop(n)["kernel"] for n in ("gate_proj", "up_proj")]
        mlp["gateup_proj"] = {"kernel": torch.cat(ks, dim=-1)}
        del ks
    return llm_params
