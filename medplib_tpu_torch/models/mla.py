"""Multi-head latent attention (DeepSeek-V2, modeling_deepseek.py's
DeepseekV2Attention with q_lora_rank null) and its latent cache. The JAX
package has no MLA; this module is the port's own, for MlaConfig.

A layer's attention params ("attn"): q_proj [H * (dn + dr), hidden]
([out, in], as q / k / v are stored), kv_a_proj_with_mqa [hidden, r + dr],
kv_a_layernorm {weight [r]}, kv_b_proj [r, H * (dn + dv)] (per head the
dn k columns, then the dv v columns), o_proj [H * dv, hidden]; r =
kv_lora_rank, dn / dr = qk_nope / qk_rope_head_dim, dv = v_head_dim.
Linears go through train/lora (int8 weight-only, W8A8 under
dynamic_act_quant at >= 512 rows, like q / k / v / o).

- compress (both phases): c = kv_a_layernorm(kv_a_proj_with_mqa(h)[:r]),
  k_pe = rope(the last dr values), one key shared by every head; the
  latent [c, k_pe] (r + dr values a token, bf16) goes into the cache;
- prefill, the expanded form: k_nope, v = kv_b_proj(c) per head, q / k
  heads [q_nope, q_pe] / [k_nope, k_pe] of dn + dr, causal attention
  through ops/attention.causal_attention (K4 at 192 / 128 on the card)
  with the YaRN softmax scale;
- decode, the absorbed form: q_nope through kv_b_proj's k half into the
  latent (q_lat = q_nope W_k^T, [H, r]), scores q_lat . c + q_pe . k_pe
  over the cached latents, the probability-weighted latent through the v
  half (W_v), then o_proj; all in f32 over the bf16 cache.

Rope follows modeling_deepseek: YaRN frequencies (ops/rope.yarn_freqs)
on the interleaved-pair layout (ops/rope.apply_rope_interleaved).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from medplib_tpu_torch.config import MlaConfig
from medplib_tpu_torch.ops.attention import NEG_INF, causal_attention
from medplib_tpu_torch.ops.initializers import dense_init
from medplib_tpu_torch.ops.norms import rms_norm
from medplib_tpu_torch.ops.rope import apply_rope_interleaved, \
    mla_softmax_scale
from medplib_tpu_torch.train.lora import dequant_kernel, linear, linear_t
from medplib_tpu_torch.utils import profiling

# DeepseekV2RMSNorm's default eps, which kv_a_layernorm keeps
KV_A_NORM_EPS = 1e-6


@dataclass
class LatentCache:
    """latent [L, B, MAX, kv_lora_rank + qk_rope_head_dim] (the normed
    c_kv, then the rope'd shared key); length [B] int32 (valid entries).
    `LatentCache.allocated_bytes` counts the bytes of every latent
    allocated in the process."""

    latent: torch.Tensor
    length: torch.Tensor

    allocated_bytes = 0

    @staticmethod
    def init(cfg: MlaConfig, batch: int, max_len: int,
             dtype=torch.bfloat16, device="cuda",
             quant: bool = False) -> "LatentCache":
        if quant:
            raise NotImplementedError(
                "MLA keeps a bf16 latent cache: the int8 KV cache "
                "(kv_quant=True) is not ported to it")
        latent = torch.zeros((cfg.num_layers, batch, max_len,
                              cfg.latent_dim), dtype=dtype, device=device)
        LatentCache.allocated_bytes += latent.numel() * latent.element_size()
        return LatentCache(latent=latent, length=torch.zeros(
            (batch,), dtype=torch.int32, device=device))

    def layer(self, i: int) -> torch.Tensor:
        """Layer i's latent view [B, MAX, r + dr]."""
        return self.latent[i]


def init_attn(gen, cfg: MlaConfig, dtype, device, lead=()) -> dict:
    """Random MLA attention params with a leading `lead` (layer) axis."""
    h, n = cfg.hidden_size, cfg.num_heads
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    t = lambda a: a.transpose(-1, -2).contiguous()  # noqa: E731 [out, in]
    return {
        "q_proj": {"kernel": t(dense_init(gen, h, n * cfg.q_head_dim, dtype,
                                          device, lead))},
        "kv_a_proj_with_mqa": {"kernel": dense_init(
            gen, h, cfg.latent_dim, dtype, device, lead)},
        "kv_a_layernorm": {"weight": torch.ones(tuple(lead) + (r,),
                                                dtype=dtype, device=device)},
        "kv_b_proj": {"kernel": dense_init(
            gen, r, n * (cfg.qk_nope_head_dim + dv), dtype, device, lead)},
        "o_proj": {"kernel": dense_init(gen, n * dv, h, dtype, device,
                                        lead)},
    }


def _queries(p, h, cfg: MlaConfig, cos, sin):
    """-> q_nope [B, T, H, dn], q_pe [B, T, H, dr] (rope'd)."""
    b, t = h.shape[:2]
    q = linear_t(p["q_proj"], h).reshape(b, t, cfg.num_heads,
                                          cfg.q_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    return q_nope, apply_rope_interleaved(q_pe, cos, sin)


def _compress(p, h, cfg: MlaConfig, cos, sin) -> torch.Tensor:
    """-> the latent [B, T, r + dr] in h.dtype: kv_a_layernorm(c), then
    the rope'd shared key."""
    kv = linear(p["kv_a_proj_with_mqa"], h)
    c, k_pe = kv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
    c = rms_norm(c, p["kv_a_layernorm"]["weight"], KV_A_NORM_EPS)
    return torch.cat([c, apply_rope_interleaved(k_pe, cos, sin)], -1)


def prefill_attention(p, h: torch.Tensor, cfg: MlaConfig, cos, sin,
                      attn_mask: Optional[torch.Tensor],
                      cache_layer: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The expanded form over a prompt. h [B, T, hidden] (normed); writes
    the latents into positions [0, T) of cache_layer [B, MAX, r + dr] when
    given. -> o_proj's output [B, T, hidden]."""
    b, t = h.shape[:2]
    n, dn, dr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dv, r = cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_pe = _queries(p, h, cfg, cos, sin)
    with profiling.span("mla.compress"):
        lat = _compress(p, h, cfg, cos, sin)
        if cache_layer is not None:
            cache_layer[:, :t] = lat.to(cache_layer.dtype)
    with profiling.span("mla.expand"):
        kv = linear(p["kv_b_proj"], lat[..., :r]).reshape(b, t, n, dn + dv)
        k_nope, v = kv.split([dn, dv], -1)
        k = torch.cat([k_nope, lat[..., None, r:].expand(b, t, n, dr)], -1)
        q = torch.cat([q_nope, q_pe], -1)
    attn = causal_attention(q, k, v.contiguous(), attn_mask,
                            scale=mla_softmax_scale(cfg))
    return linear(p["o_proj"], attn.reshape(b, t, n * dv))


def _kv_b_halves(p, cfg: MlaConfig):
    """kv_b_proj as f32 [r, H, dn] (the k half) and [r, H, dv] (v)."""
    w = dequant_kernel(p["kv_b_proj"], torch.float32).float()
    w = w.reshape(cfg.kv_lora_rank, cfg.num_heads,
                  cfg.qk_nope_head_dim + cfg.v_head_dim)
    return w.split([cfg.qk_nope_head_dim, cfg.v_head_dim], -1)


def decode_attention(p, h: torch.Tensor, cfg: MlaConfig, cos, sin,
                     cache_layer: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """The absorbed form for one token a row. h [B, 1, hidden] (normed);
    writes its latent at row position `length` of cache_layer
    [B, MAX, r + dr] (a row whose length has reached the cache's size
    writes nothing, as in llama.decoder_layer_decode) and attends to the
    first length + 1. -> o_proj's output [B, 1, hidden]."""
    b = h.shape[0]
    r, n = cfg.kv_lora_rank, cfg.num_heads
    q_nope, q_pe = _queries(p, h, cfg, cos, sin)
    with profiling.span("mla.compress"):
        lat = _compress(p, h, cfg, cos, sin)[:, 0]
        bidx = torch.arange(b, device=h.device)
        pos = length.long()
        ok = pos < cache_layer.shape[1]
        pos = pos.clamp(max=cache_layer.shape[1] - 1)
        cache_layer[bidx, pos] = torch.where(
            ok[:, None], lat.to(cache_layer.dtype), cache_layer[bidx, pos])
    with profiling.span("mla.absorb"):
        w_k, w_v = _kv_b_halves(p, cfg)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_k)
        c = cache_layer[..., :r].float()                    # [B, S, r]
        s = torch.einsum("bhr,bsr->bhs", q_lat, c) + torch.einsum(
            "bhd,bsd->bhs", q_pe[:, 0].float(), cache_layer[..., r:].float())
        s = s * mla_softmax_scale(cfg)
        valid = torch.arange(cache_layer.shape[1], device=h.device)[None] \
            < (length + 1)[:, None]
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
        o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c)
        o = torch.einsum("bhr,rhd->bhd", o_lat, w_v).to(h.dtype)
    return linear(p["o_proj"], o.reshape(b, 1, n * cfg.v_head_dim))
