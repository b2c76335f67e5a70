"""Rotary position embeddings, HF half-rotation layout
(medplib_tpu/ops/rope.py), and DeepSeek-V2's YaRN-scaled rope on the
interleaved-pair layout of modeling_deepseek.py (DeepseekV2YarnRotary-
Embedding, apply_rotary_pos_emb), which the JAX package does not have."""

from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0):
    """positions [..., T] -> cos/sin [..., T, head_dim]."""
    inv = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * inv
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [B, T, D] or [T, D]."""
    if cos.dim() == x.dim() - 1:
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# YaRN (DeepSeek-V2): frequencies, the cos / sin scale, the softmax scale
# ---------------------------------------------------------------------------

def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, base: float,
                         max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_freqs(dim: int, theta: float, yarn, device=None):
    """-> ([dim/2] inverse frequencies, the cos / sin factor): the
    interpolated frequencies (theta^(-2i/dim) / factor) below the low
    correction dimension, the original ones above the high one, a linear
    ramp between; yarn is a config.YarnScaling."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (theta ** exps)
    freq_inter = 1.0 / (yarn.factor * theta ** exps)
    low = math.floor(_yarn_correction_dim(
        yarn.beta_fast, dim, theta, yarn.original_max_position_embeddings))
    high = math.ceil(_yarn_correction_dim(
        yarn.beta_slow, dim, theta, yarn.original_max_position_embeddings))
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp
    inv = freq_inter * (1 - extra) + freq_extra * extra
    mscale = (yarn_get_mscale(yarn.factor, yarn.mscale)
              / yarn_get_mscale(yarn.factor, yarn.mscale_all_dim))
    return inv, mscale


def mla_rope_cos_sin(positions: torch.Tensor, cfg):
    """positions [..., T] -> cos / sin [..., T, qk_rope_head_dim] of an
    MlaConfig (YaRN when it has rope_scaling)."""
    dim = cfg.qk_rope_head_dim
    if cfg.rope_scaling is None:
        inv, mscale = rope_freqs(dim, cfg.rope_theta, positions.device), 1.0
    else:
        inv, mscale = yarn_freqs(dim, cfg.rope_theta, cfg.rope_scaling,
                                 positions.device)
    angles = positions[..., None].float() * inv
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles) * mscale, torch.sin(angles) * mscale


def mla_softmax_scale(cfg) -> float:
    """q_head_dim^-0.5, times yarn_get_mscale(factor, mscale_all_dim)^2
    under YaRN (DeepseekV2Attention.softmax_scale)."""
    scale = cfg.q_head_dim ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        m = yarn_get_mscale(y.factor, y.mscale_all_dim)
        scale = scale * m * m
    return scale


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """modeling_deepseek's apply_rotary_pos_emb: the interleaved pairs
    (x0, x1), (x2, x3), .. of x [B, T, (H,) D] are regrouped as
    (x0, x2, .., x1, x3, ..) and rotated in the half layout; the result
    stays regrouped (q and k alike). cos / sin [B, T, D]."""
    if cos.dim() == x.dim() - 1:
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    d = x.shape[-1]
    xf = x.float().reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2) \
        .reshape(x.shape)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
