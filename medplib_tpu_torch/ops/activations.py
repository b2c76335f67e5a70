"""Activations shared by the model's layers and the kernels' plain
versions."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu's exact op sequence, x * (1 / (1 + exp(-x))), each op
    rounded in x.dtype (F.silu rounds once, which flips bf16 results)."""
    return x * (1 / (1 + torch.exp(-x)))
