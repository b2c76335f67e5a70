"""Parameter initializers (medplib_tpu/ops/initializers.py). Random draws
come from an explicit torch.Generator; they are not the JAX package's
numbers (tests bridge JAX weights instead)."""

from __future__ import annotations

import torch


def normal(gen: torch.Generator, shape, dtype, device, scale=1.0):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(generator=gen)
    return (t * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, device="cuda", lead=()):
    """Kernel [*lead, in_dim, out_dim], truncated normal in [-2, 2] scaled
    by in_dim ** -0.5."""
    t = torch.empty(tuple(lead) + (in_dim, out_dim), dtype=torch.float32,
                    device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * in_dim ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device="cuda", scale=0.02):
    return normal(gen, (vocab, dim), dtype, device, scale)
