"""Rotary position embeddings, HF half-rotation layout
(medplib_tpu/ops/rope.py)."""

from __future__ import annotations

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
