"""MPT-family decoder (medplib_tpu/models/mpt.py): the reference's legacy
MPT stack. ALiBi bias (gen_slopes / build_alibi_bias), clip_qkv, qk_ln,
softmax_scale, the pre-LN block with a low-precision layernorm (statistics
in float32), no_bias, learned positions, and the bidirectional prefix of a
prefix LM.

Params are a tree like models/llama.py's, the per-layer weights stacked
on a leading [n_layers] axis. Attention is plain PyTorch: scores and
softmax in float32, probabilities cast to the activation dtype before the
product with v, as the JAX package's XLA attention does (the flash
kernels are causal only and take no additive bias, which ALiBi needs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from medplib_tpu_torch.ops.initializers import dense_init, embed_init

Params = Dict[str, Any]
NEG_INF = -2.3819763e38  # finite: a fully masked row softmaxes to uniform


@dataclasses.dataclass(frozen=True)
class MptConfig:
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 24
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    vocab_size: int = 50368
    no_bias: bool = False
    learned_pos_emb: bool = True
    alibi: bool = False
    alibi_bias_max: int = 8
    clip_qkv: Optional[float] = None
    qk_ln: bool = False
    softmax_scale: Optional[float] = None
    prefix_lm: bool = False
    ln_eps: float = 1e-5

    @staticmethod
    def tiny() -> "MptConfig":
        return MptConfig(d_model=64, n_heads=4, n_layers=2, max_seq_len=128,
                         vocab_size=512)


def mpt_7b_config() -> MptConfig:
    """mosaicml/mpt-7b (its model card and config.json): d_model 4096, 32
    heads, 32 layers, expansion ratio 4, vocabulary 50432, 2048 positions,
    ALiBi (alibi_bias_max 8) without a position table, no biases."""
    return MptConfig(d_model=4096, n_heads=32, n_layers=32,
                     expansion_ratio=4, max_seq_len=2048, vocab_size=50432,
                     no_bias=True, learned_pos_emb=False, alibi=True,
                     alibi_bias_max=8)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_mpt(gen: torch.Generator, cfg: MptConfig, dtype=torch.float32,
             device="cuda") -> Params:
    """Random params from `gen`, one layer at a time (float32 temporaries
    stay one layer in size). Kernels are [in, out]."""
    d, L, bias = cfg.d_model, cfg.n_layers, not cfg.no_bias
    f = cfg.expansion_ratio * d

    def stack(*shape):
        return torch.empty((L,) + shape, dtype=dtype, device=device)

    def lin(din, dout):
        p = {"kernel": stack(din, dout)}
        if bias:
            p["bias"] = torch.zeros((L, dout), dtype=dtype, device=device)
        return p

    def ln(lead=(L,)):
        p = {"weight": torch.ones(lead + (d,), dtype=dtype, device=device)}
        if bias:
            p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
        return p

    params = {"wte": {"embedding": embed_init(gen, cfg.vocab_size, d, dtype,
                                              device)}}
    if cfg.learned_pos_emb and not cfg.alibi:
        params["wpe"] = {"embedding": embed_init(gen, cfg.max_seq_len, d,
                                                 dtype, device)}
    blocks = {"norm_1": ln(),
              "attn": {"Wqkv": lin(d, 3 * d), "out_proj": lin(d, d)},
              "norm_2": ln(),
              "ffn": {"up_proj": lin(d, f), "down_proj": lin(f, d)}}
    if cfg.qk_ln:
        blocks["attn"]["q_ln"] = ln()
        blocks["attn"]["k_ln"] = ln()
    kernels = ((blocks["attn"]["Wqkv"], d, 3 * d),
               (blocks["attn"]["out_proj"], d, d),
               (blocks["ffn"]["up_proj"], d, f),
               (blocks["ffn"]["down_proj"], f, d))
    for i in range(L):
        for node, din, dout in kernels:
            node["kernel"][i] = dense_init(gen, din, dout, dtype, device)
    params["blocks"] = blocks
    params["norm_f"] = ln(())
    return params


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------

def alibi_slopes(n_heads: int, bias_max: int = 8,
                 device="cuda") -> torch.Tensor:
    """[H] slopes 2^-(bias_max k / pow2), k = 1..pow2, interleaved when
    n_heads is not a power of 2."""
    pow2 = 2 ** math.ceil(math.log2(n_heads))
    m = torch.arange(1, pow2 + 1, dtype=torch.float32,
                     device=device) * (bias_max / pow2)
    slopes = 1.0 / (2.0 ** m)
    if pow2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes


def alibi_bias(n_heads: int, q_pos: torch.Tensor, k_pos: torch.Tensor,
               bias_max: int = 8) -> torch.Tensor:
    """-> [H, Tq, Tk] additive bias: -slope x |k - q|."""
    dist = (k_pos[None, :] - q_pos[:, None]).abs().float()
    return -alibi_slopes(n_heads, bias_max, q_pos.device)[:, None, None] \
        * dist[None]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_ln(p, x, eps):
    """Low-precision layernorm: statistics in float32, output in x.dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["weight"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def _lin(p, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def _attn_mask_bias(cfg: MptConfig, q_pos, k_pos, pad_mask, prefix_mask):
    """[B or 1, H or 1, Tq, Tk] additive float32 bias: causality (with a
    bidirectional prefix for a prefix LM), padding and ALiBi."""
    allowed = (k_pos[None, :] <= q_pos[:, None])[None]
    if cfg.prefix_lm and prefix_mask is not None:
        pm = prefix_mask.bool()
        allowed = allowed | (pm[:, None, :] & pm[:, q_pos, None])
    if pad_mask is not None:
        allowed = allowed & (pad_mask[:, None, :] > 0)
    bias = torch.where(allowed[:, None], 0.0, NEG_INF).float()
    if cfg.alibi:
        bias = bias + alibi_bias(cfg.n_heads, q_pos, k_pos,
                                 cfg.alibi_bias_max)[None]
    return bias


def _attention(p, cfg: MptConfig, x, bias, kv: Optional[Tuple] = None):
    b, t, d = x.shape
    h = cfg.n_heads
    qkv = _lin(p["Wqkv"], x)
    if cfg.clip_qkv is not None:
        qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
    q, k, v = qkv.split(d, dim=-1)
    if cfg.qk_ln:
        q = _apply_ln(p["q_ln"], q, cfg.ln_eps)
        k = _apply_ln(p["k_ln"], k, cfg.ln_eps)
    if kv is not None:                       # decode: the past first
        k = torch.cat([kv[0], k], dim=1)
        v = torch.cat([kv[1], v], dim=1)
    s = k.shape[1]
    qh = q.reshape(b, t, h, d // h)
    kh = k.reshape(b, s, h, d // h)
    vh = v.reshape(b, s, h, d // h)
    scale = cfg.softmax_scale or 1.0 / math.sqrt(d / h)
    logits = torch.einsum("bthc,bshc->bhts", qh.float(), kh.float()) * scale
    probs = torch.softmax(logits + bias, -1).to(x.dtype)
    out = torch.einsum("bhts,bshc->bthc", probs, vh).reshape(b, t, d)
    return _lin(p["out_proj"], out), (k, v)


def _block(p, cfg: MptConfig, x, bias, kv=None):
    a, new_kv = _attention(p["attn"], cfg,
                           _apply_ln(p["norm_1"], x, cfg.ln_eps), bias, kv)
    x = x + a
    hdn = F.gelu(_lin(p["ffn"]["up_proj"],
                      _apply_ln(p["norm_2"], x, cfg.ln_eps)),
                 approximate="tanh")
    return x + _lin(p["ffn"]["down_proj"], hdn), new_kv


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class MptCache(NamedTuple):
    k: torch.Tensor  # [L, B, T, D]
    v: torch.Tensor


def forward(params: Params, cfg: MptConfig, input_ids: torch.Tensor,
            pad_mask: Optional[torch.Tensor] = None,
            prefix_mask: Optional[torch.Tensor] = None,
            past: Optional[MptCache] = None):
    """-> (logits [B, T, V], MptCache). With `past` (the cache of the
    previous call) input_ids holds only the new tokens; pad_mask and
    prefix_mask cover the past and the new positions."""
    b, t = input_ids.shape
    dev = input_ids.device
    past_len = 0 if past is None else past.k.shape[2]
    x = params["wte"]["embedding"][input_ids]
    pos = torch.arange(past_len, past_len + t, device=dev)
    if "wpe" in params:
        x = x + params["wpe"]["embedding"][pos]
    k_pos = torch.arange(past_len + t, device=dev)
    if pad_mask is None:
        pad_mask = torch.ones((b, past_len + t), dtype=torch.int32,
                              device=dev)
    bias = _attn_mask_bias(cfg, pos, k_pos, pad_mask, prefix_mask)

    ks, vs = [], []
    for i in range(cfg.n_layers):
        kv = None if past is None else (past.k[i], past.v[i])
        x, (k, v) = _block(_layer(params["blocks"], i), cfg, x, bias, kv)
        ks.append(k)
        vs.append(v)
    x = _apply_ln(params["norm_f"], x, cfg.ln_eps)
    logits = x @ params["wte"]["embedding"].t()      # tied embeddings
    return logits, MptCache(torch.stack(ks), torch.stack(vs))


@torch.no_grad()
def greedy_generate(params: Params, cfg: MptConfig, input_ids: torch.Tensor,
                    max_new_tokens: int, eos_id: int = 0) -> torch.Tensor:
    """Greedy decode, one forward per token over the growing cache ->
    [B, max_new_tokens] (eos_id is accepted for the JAX signature; decode
    runs the full budget, as there)."""
    logits, cache = forward(params, cfg, input_ids)
    out = []
    tok = logits[:, -1].argmax(-1)
    for _ in range(max_new_tokens):
        out.append(tok)
        logits, cache = forward(params, cfg, tok[:, None], past=cache)
        tok = logits[:, -1].argmax(-1)
    return torch.stack(out, dim=1)
