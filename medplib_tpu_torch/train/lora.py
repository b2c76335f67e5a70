"""Inference linears of medplib_tpu/train/lora.py: dequant and the W8A8
switch. LoRA injection and training are not ported yet.

A linear node is {"kernel", optional "scale" (int8) / "scale4h" (int4h),
optional "bias"}; kernels are [in, out], or [out, in] for the names in
TRANSPOSED_KERNELS (linear_t).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]

# kernels stored [out, in] instead of [in, out]
TRANSPOSED_KERNELS = ("q_proj", "k_proj", "v_proj", "qkv_proj")


def dequant_kernel(p: Params, dtype) -> torch.Tensor:
    """The kernel as `dtype`: int8 nodes multiply by their per-channel
    scale in `dtype` (as the JAX package does), int4h nodes dequantize
    through dequant_int4h, float kernels pass through."""
    kern = p["kernel"]
    if "scale4h" in p:
        from medplib_tpu_torch.utils.quantize import dequant_int4h
        return dequant_int4h(kern, p["scale4h"], dtype)
    if kern.dtype == torch.int8:
        return kern.to(dtype) * p["scale"].to(dtype)
    return kern


def _use_w8a8(p: Params, x: torch.Tensor) -> bool:
    """W8A8 engages under dynamic_act_quant() for 2D int8 nodes when the
    call has >= 512 rows (prefill); decode stays weight-only."""
    if "scale" not in p or p["kernel"].dtype != torch.int8 \
            or p["kernel"].dim() != 2 or "lora_a" in p:
        return False
    from medplib_tpu_torch.utils.quantize import act_quant_enabled
    if not act_quant_enabled():
        return False
    rows = 1
    for d in x.shape[:-1]:
        rows *= d
    return rows >= 512


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel (+ bias)."""
    if _use_w8a8(p, x):
        from medplib_tpu_torch.utils.quantize import int8_dyn_matmul
        y = int8_dyn_matmul(x, p["kernel"], p["scale"], transposed=False)
    else:
        y = x @ dequant_kernel(p, x.dtype)
    if "bias" in p:
        y = y + p["bias"]
    return y


def linear_t(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear with a transposed [out, in] kernel (q/k/v storage)."""
    if _use_w8a8(p, x):
        from medplib_tpu_torch.utils.quantize import int8_dyn_matmul
        y = int8_dyn_matmul(x, p["kernel"], p["scale"], transposed=True)
    else:
        y = x @ dequant_kernel(p, x.dtype).t()
    if "bias" in p:
        y = y + p["bias"]
    return y
