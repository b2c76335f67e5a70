"""Matmuls against int8 weights with per-output-channel scales: weight-only
(kernel K7) and dynamic W8A8 (kernel K8).

Counterpart of medplib_tpu/ops/pallas/int8_matmul.py:

- `int8_matmul` / `int8_matmul_t`: y = x @ dequant(w), the int8 weight
  converted to x's dtype (exact), f32 sums, the f32 per-channel scale
  applied to the sum, one cast to x's dtype. The CUDA entry is
  csrc/int8_matmul.cu (`int8_matmul_launch`): bf16 x (the serving dtype)
  runs bf16 mma.sync on the tensor cores (csrc/int8w_mma.cuh, the bytes
  decoded to bf16 exactly in registers), f32 x an f32-FMA kernel, since a
  bf16 product would round x. Reached by the packed
  `qkv_proj` / `gateup_proj` kernels of a pack_inference tree
  (models/llama.py); unpacked int8 linears keep the dequantize-then-matmul
  route of train/lora.linear, whose rounding differs.
- `w8a8_matmul` / `w8a8_matmul_t`: per-row dynamic int8 activation quant
  (ops/cuda/gmm.quantize_rows, outside the kernel as in the reference), an
  exact s32 product, the epilogue (acc * a_scale) * w_scale in f32, then a
  cast to x's dtype. The CUDA entry is csrc/int8_matmul.cu
  (`w8a8_matmul_launch`): s8 mma.sync m16n8k32 on the tensor cores
  (csrc/s8_mma.cuh), exact s32 sums, bit-equal to the plain version. The
  JAX package has no model caller for it, and neither has the port.

Weights are [K, N] with scale [1, N], or transposed [N, K] with scale
[N, 1]. On a CPU tensor the kernel wrappers (`int8_matmul_2d`,
`w8a8_matmul_2d`, which takes the quantized x) run their plain PyTorch
versions; on a CUDA tensor they launch their kernels or raise. Each counts
its launches.
"""

from __future__ import annotations

import torch

from medplib_tpu_torch.ops.cuda.gmm import _check_cuda, quantize_rows
from medplib_tpu_torch.ops.cuda.pad import pad_operands

_X_DTYPES = {torch.bfloat16: 1, torch.float32: 2}


def _shapes(x2d, w, scale, transposed):
    m, k = x2d.shape
    n, kw = (w.shape[0], w.shape[1]) if transposed else (w.shape[1],
                                                         w.shape[0])
    want = (n, 1) if transposed else (1, n)
    if kw != k or tuple(scale.shape) != want or w.dtype != torch.int8:
        raise ValueError(
            f"shape mismatch: x {tuple(x2d.shape)}, w {tuple(w.shape)} "
            f"{w.dtype}, scale {tuple(scale.shape)} (transposed="
            f"{transposed}: w [N, K] + scale [N, 1], else w [K, N] + scale "
            f"[1, N])")
    return m, k, n


def int8_matmul_plain(x2d: torch.Tensor, w: torch.Tensor,
                      scale: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Plain PyTorch version of K7, any device: x.float() @ w.float() (f32
    sums; TF32 must be off on a GPU), times the f32 scale, cast once."""
    wf = w.float().t() if transposed else w.float()
    y = (x2d.float() @ wf) * scale.float().reshape(1, -1)
    return y.to(x2d.dtype)


def _padded(x, w, scale, transposed):
    """The CUDA kernels' weight checks, then x, w and scale zero-padded to
    K % 16 == 0 and N % 16 == 0 (the kernels' 16-byte loads) -> (x, w,
    scale, padded N)."""
    _check_cuda("w", w, torch.int8, tuple(w.shape), x.device)
    _check_cuda("scale", scale, torch.float32, tuple(scale.shape), x.device)
    kn = (1, 0) if transposed else (0, 1)
    x, w, scale = pad_operands(x, w, scale, 16, 16, *kn, scale_n_dim=kn[1])
    return x, w, scale, w.shape[kn[1]]


def int8_matmul_2d(x2d: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   transposed: bool) -> torch.Tensor:
    """Kernel K7: x2d [M, K] (bf16 or f32) @ dequant(w) -> [M, N] in x's
    dtype."""
    m, k, n = _shapes(x2d, w, scale, transposed)
    if x2d.device.type == "cpu":
        return int8_matmul_plain(x2d, w, scale, transposed)
    if not x2d.is_cuda:
        raise ValueError(f"int8_matmul: unsupported device {x2d.device}")
    from medplib_tpu_torch.ops.cuda._build import check, load_library
    if x2d.dtype not in _X_DTYPES:
        raise TypeError(f"int8_matmul: the CUDA kernel takes bf16 or f32 x, "
                        f"got {x2d.dtype}")
    dev = x2d.device
    _check_cuda("x", x2d, x2d.dtype, (m, k), dev)
    xk, wk, sk, n_run = _padded(x2d, w, scale, transposed)
    out = torch.empty((m, n_run), device=dev, dtype=x2d.dtype)
    if m:
        lib = load_library()
        err = lib.int8_matmul_launch(
            xk.data_ptr(), wk.data_ptr(), sk.data_ptr(), out.data_ptr(), m,
            xk.shape[1], n_run, _X_DTYPES[x2d.dtype], int(transposed),
            torch.cuda.current_stream(dev).cuda_stream)
        check(err, "int8_matmul")
        int8_matmul_2d.launches += 1
    return out if n_run == n else out[:, :n].contiguous()


int8_matmul_2d.launches = 0


def _int8(x, w_q, scale, transposed):
    y = int8_matmul_2d(x.reshape(-1, x.shape[-1]).contiguous(), w_q, scale,
                       transposed)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [K, N], scale [1, N]) -> [..., N]."""
    return _int8(x, w_q, scale, False)


def int8_matmul_t(x: torch.Tensor, w_q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [N, K], scale [N, 1]).T -> [..., N]."""
    return _int8(x, w_q, scale, True)


def w8a8_matmul_plain(x_q: torch.Tensor, a_scale: torch.Tensor,
                      w: torch.Tensor, scale: torch.Tensor, transposed: bool,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K8, any device: the int8 products summed in
    float64 (every partial sum an exact integer), rounded to f32 as the
    kernel converts its s32 sum, then * a_scale, then * w_scale, each
    product rounded in f32, then cast."""
    wd = w.double().t() if transposed else w.double()
    acc = (x_q.double() @ wd).float()
    y = acc * a_scale.float()
    y = y * scale.float().reshape(1, -1)
    return y.to(out_dtype)


def w8a8_matmul_2d(x_q: torch.Tensor, a_scale: torch.Tensor,
                   w: torch.Tensor, scale: torch.Tensor, transposed: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel K8: x_q [M, K] int8 with a_scale [M, 1] f32 (quantize_rows)
    against the int8 weight, an exact s32 product, rescaled -> [M, N] in
    out_dtype (bf16 or f32)."""
    m, k, n = _shapes(x_q, w, scale, transposed)
    if tuple(a_scale.shape) != (m, 1):
        raise ValueError(f"a_scale must be [{m}, 1], got "
                         f"{tuple(a_scale.shape)}")
    if x_q.device.type == "cpu":
        return w8a8_matmul_plain(x_q, a_scale, w, scale, transposed,
                                 out_dtype)
    if not x_q.is_cuda:
        raise ValueError(f"w8a8_matmul: unsupported device {x_q.device}")
    from medplib_tpu_torch.ops.cuda._build import check, load_library
    if out_dtype not in _X_DTYPES:
        raise TypeError(f"w8a8_matmul: the CUDA kernel writes bf16 or f32, "
                        f"not {out_dtype}")
    dev = x_q.device
    _check_cuda("x_q", x_q, torch.int8, (m, k), dev)
    _check_cuda("a_scale", a_scale, torch.float32, (m, 1), dev)
    xk, wk, sk, n_run = _padded(x_q, w, scale, transposed)
    out = torch.empty((m, n_run), device=dev, dtype=out_dtype)
    if m:
        lib = load_library()
        err = lib.w8a8_matmul_launch(
            xk.data_ptr(), a_scale.data_ptr(), wk.data_ptr(), sk.data_ptr(),
            out.data_ptr(), m, xk.shape[1], n_run, _X_DTYPES[out_dtype],
            int(transposed), torch.cuda.current_stream(dev).cuda_stream)
        check(err, "w8a8_matmul")
        w8a8_matmul_2d.launches += 1
    return out if n_run == n else out[:, :n].contiguous()


w8a8_matmul_2d.launches = 0


def _w8a8(x, w_q, scale, transposed):
    x_q, a_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    y = w8a8_matmul_2d(x_q, a_scale, w_q, scale, transposed, x.dtype)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] (float) @ dequant(w_q [K, N], scale [1, N]) via dynamic
    W8A8: per-row activation quant, then kernel K8."""
    return _w8a8(x, w_q, scale, False)


def w8a8_matmul_t(x: torch.Tensor, w_q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [N, K], scale [N, 1]).T via W8A8."""
    return _w8a8(x, w_q, scale, True)
