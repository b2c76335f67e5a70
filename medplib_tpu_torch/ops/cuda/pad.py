"""Zero padding of a matmul's operands to the multiples a CUDA kernel
needs (plain PyTorch).

The Pallas wrappers pad their operands per call (medplib_tpu/ops/pallas/
int8_matmul.py, int4_matmul.py); the CUDA wrappers of K1, K3, K7, K8 and
K9 (f32 x) do the same where K or N is no multiple of what their kernel's
16-byte loads take. Zero rows of x and the weight along K add exact zeros
to every sum, and zero weight / scale columns along N give output columns
the caller slices off, so results are unchanged.

This copies the weight on every call. Only odd-width configurations pay
for it: the 7B shapes are multiples already, and then the operands come
back as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_dim(t: torch.Tensor, dim: int, extra: int) -> torch.Tensor:
    """t with `extra` zeros appended along `dim` (t itself if extra == 0)."""
    if not extra:
        return t
    dim %= t.dim()
    return F.pad(t, [0, 0] * (t.dim() - 1 - dim) + [0, extra]).contiguous()


def pad_operands(x: torch.Tensor, w: torch.Tensor,
                 scale: torch.Tensor | None, k_mult: int, n_mult: int,
                 w_k_dim: int, w_n_dim: int, scale_n_dim: int = -1,
                 k_per_w_row: int = 1):
    """-> (x, w, scale) zero-padded so that K % k_mult == 0 and
    N % n_mult == 0: x [..., K] along its last dim; w along w_k_dim (each
    stored row holding k_per_w_row logical k: 2 for packed int4h) and
    along w_n_dim; scale (or None) along scale_n_dim. k_mult is a multiple
    of k_per_w_row."""
    dk = -x.shape[-1] % k_mult
    dn = -w.shape[w_n_dim] % n_mult
    x = _pad_dim(x, -1, dk)
    w = _pad_dim(_pad_dim(w, w_k_dim, dk // k_per_w_row), w_n_dim, dn)
    if scale is not None:
        scale = _pad_dim(scale, scale_n_dim, dn)
    return x, w, scale
