"""Normalization ops (medplib_tpu/ops/norms.py): computed in float32, cast
back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """LLaMA RMSNorm: x * rsqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_2d(x, weight, bias, eps: float = 1e-6):
    """Channels-last LayerNorm2d over the channel axis of NHWC maps."""
    return layer_norm(x, weight, bias, eps)
