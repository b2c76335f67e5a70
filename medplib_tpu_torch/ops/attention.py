"""Attention: batched causal prefill, single-step cached decode and the
chunked-prefill extend over a bf16 or an int8 KV cache
(medplib_tpu/ops/attention.py). Public layout [B, T, H, D], as in JAX.

Scores are formed in float32 (the JAX einsums ask for f32 accumulation);
softmax probabilities are cast back to the activation dtype before the
value product, as there.
"""

from __future__ import annotations

from typing import Optional

import torch

from medplib_tpu_torch.ops.cuda.flash_attention import (flash_attention,
                                                        fwd_dims_supported)

NEG_INF = -2.3819763e38  # ~ -max bf16, the JAX package's mask value


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] (GQA head replication)."""
    if n_rep == 1:
        return x
    b, s, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, d).reshape(
        b, s, kv * n_rep, d)


def _plain_attention(q, k, v, bias, scale: Optional[float] = None):
    """q:[B,T,H,D] k:[B,S,H,D] v:[B,S,H,Dv] bias:[B,1,T,S] additive or
    None; scale default D^-0.5."""
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits * (d ** -0.5 if scale is None else scale)
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def make_causal_bias(attn_mask: Optional[torch.Tensor], q_len: int,
                     kv_len: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Additive bias [B,1,T,S]: causality (queries occupy the last q_len
    slots of the kv axis) combined with an optional [B,S] padding mask."""
    if attn_mask is not None:
        device = attn_mask.device
    offset = kv_len - q_len
    qi = torch.arange(q_len, device=device)[:, None] + offset
    ki = torch.arange(kv_len, device=device)[None, :]
    allowed = (qi >= ki)[None, None]
    if attn_mask is not None:
        allowed = allowed & attn_mask[:, None, None, :].bool()
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=device)
    return torch.where(allowed, zero, neg)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     attn_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention. q [B, T, H, D]; k [B, S, KV, D], v [B, S, KV, Dv]
    with S >= T; attn_mask optional [B, S] 1=keep; scale: the softmax
    scale (default D^-0.5).

    On a CUDA tensor with head sizes the kernels take (D = Dv = 128, or,
    in bf16 and forward only, D = 192 with Dv = 128: DeepSeek-V2's latent
    attention in its expanded form), every prompt takes flash attention
    (ops/cuda/flash_attention.py, kernels K4-K6), whatever its length.
    The JAX package sends only prompts of >= 1024 tokens to its TPU
    kernel; on the H100 K4 is faster than the plain path from 16 tokens
    up, forward alone and with the backward (scripts/flash_crossover.py
    times both): below ~256 tokens the plain path pays ~8 launches to
    K4's one, above it f32 [B, H, T, S] scores.
    Everything else, the CPU and other head sizes, takes the plain path,
    which computes the same function (a row that keeps no key is finite on
    both routes, but not equal: flash_attention.py) and counts its calls in
    `causal_attention.plain_calls`."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if q.is_cuda and fwd_dims_supported(q, v):
        return flash_attention(q, k, v, attn_mask=attn_mask, causal=True,
                               scale=scale)
    causal_attention.plain_calls += 1
    bias = make_causal_bias(attn_mask, q.shape[1], k.shape[1],
                            device=q.device)
    return _plain_attention(q, k, v, bias, scale)


causal_attention.plain_calls = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One decode step: q [B, 1, H, D] vs cache [B, MAX, KV, D]; positions
    >= cache_len (per row) are masked out."""
    n_rep = q.shape[2] // k_cache.shape[2]
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(),
                          k.float()) * (d ** -0.5)
    pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    valid = pos < cache_len.reshape(-1, 1, 1, 1)
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def decode_attention_quant(q: torch.Tensor, k_q: torch.Tensor,
                           k_s: torch.Tensor, v_q: torch.Tensor,
                           v_s: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """One decode step over an int8 KV cache with per-token-per-head
    scales. q [B, 1, H, D]; k_q / v_q [B, MAX, KV, D] int8; k_s / v_s
    [B, MAX, KV, 1] f32. The scales apply after the products, in the
    reference's order: logits = (scores * k_s) * d^-0.5, and the softmax
    probabilities times v_s in f32, cast to q.dtype, meet the int8 values
    (as q.dtype, exact) in the value product."""
    n_rep = q.shape[2] // k_q.shape[2]
    k = _repeat_kv(k_q.to(q.dtype), n_rep)
    v = _repeat_kv(v_q.to(q.dtype), n_rep)
    ks = _repeat_kv(k_s, n_rep).permute(0, 2, 3, 1)        # [B, H, 1, S]
    vs = _repeat_kv(v_s, n_rep).permute(0, 2, 3, 1)
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits * ks.float() * (d ** -0.5)
    pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    valid = pos < cache_len.reshape(-1, 1, 1, 1)
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = (probs * vs.float()).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _causal_from(logits: torch.Tensor, c0: int) -> torch.Tensor:
    """Mask [B, H, C, S] scores: query j sits at absolute position c0 + j
    and sees cache positions <= its own."""
    c, s = logits.shape[-2:]
    dev = logits.device
    qpos = (c0 + torch.arange(c, device=dev)).reshape(1, 1, -1, 1)
    pos = torch.arange(s, device=dev)[None, None, None, :]
    return logits.masked_fill(pos > qpos, NEG_INF)


def extend_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, c0: int) -> torch.Tensor:
    """Chunked-prefill extend: q [B, C, H, D] holds the prompt tokens at
    absolute positions [c0, c0 + C), whose K/V are already in the cache
    [B, MAX, KV, D]; each query attends causally to the whole cache."""
    n_rep = q.shape[2] // k_cache.shape[2]
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(),
                          k.float()) * (d ** -0.5)
    probs = torch.softmax(_causal_from(logits, c0), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def extend_attention_quant(q: torch.Tensor, k_q: torch.Tensor,
                           k_s: torch.Tensor, v_q: torch.Tensor,
                           v_s: torch.Tensor, c0: int) -> torch.Tensor:
    """extend_attention over an int8 KV cache, its scales applied after
    the products as in decode_attention_quant."""
    n_rep = q.shape[2] // k_q.shape[2]
    k = _repeat_kv(k_q.to(q.dtype), n_rep)
    v = _repeat_kv(v_q.to(q.dtype), n_rep)
    ks = _repeat_kv(k_s, n_rep).permute(0, 2, 3, 1)        # [B, H, 1, S]
    vs = _repeat_kv(v_s, n_rep).permute(0, 2, 3, 1)
    d = q.shape[-1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits * ks.float() * (d ** -0.5)
    probs = torch.softmax(_causal_from(logits, c0), dim=-1)
    probs = (probs * vs.float()).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def quantize_kv(x: torch.Tensor):
    """[..., D] -> (int8 values, f32 scale [..., 1]): symmetric absmax per
    leading index (per token per head for cache writes). As compiled, the
    scale is max(absmax, 1e-6) * f32(1/127); x / scale stays a division
    and rounds half to even."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6) * (1 / 127)
    return torch.round(xf / s).to(torch.int8), s
