"""Matmul against an int4 "interleaved pairs" weight with G scale groups
along the reduction axis (kernel K9).

Counterpart of medplib_tpu/ops/pallas/int4_matmul.py: `int4h_matmul` /
`int4h_matmul_t` (`int4h_matmul_pallas` / `int4h_matmul_t_pallas` there),
y = x @ dequant(w): each weight is its sign-extended nibble times its
group's f32 scale (in f32), the products summed in f32, one cast to x's
dtype. The CUDA kernels are in csrc/int4_matmul.cu: on bf16 x (the serving
dtype) a tensor-core kernel that sums x * nibble per group in f32 and
scales each group's sum (the same f32 sums in another order, one rounding
per weight fewer); on f32 x an f32-FMA kernel that scales the weight, as
the plain version. Reached by the packed `qkv_proj` / `gateup_proj`
kernels of an int4h pack_inference tree (models/llama.py); the other 2D
int4h linears take the grouped products of utils/quantize.int4h_matmul,
as in the JAX package.

Layouts (utils/quantize._quantize_kernel4h): packed [K/2, N] + scale
[G, 1, N], or transposed packed [N, K/2] + scale [G, N, 1]. On a CPU tensor
the kernel wrapper `int4h_matmul_2d` runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. It counts its launches.
"""

from __future__ import annotations

import torch

from medplib_tpu_torch.ops.cuda.gmm import _check_cuda, unpack_pairs
from medplib_tpu_torch.ops.cuda.pad import pad_operands

_X_DTYPES = {torch.bfloat16: 1, torch.float32: 2}


def _shapes(x2d, packed, scale, transposed):
    m, k = x2d.shape
    g = scale.shape[0]
    n, k2 = (packed.shape[0], packed.shape[1]) if transposed else (
        packed.shape[1], packed.shape[0])
    want = (g, n, 1) if transposed else (g, 1, n)
    if 2 * k2 != k or tuple(scale.shape) != want or k % (2 * g) \
            or packed.dtype != torch.int8:
        raise ValueError(
            f"shape mismatch: x {tuple(x2d.shape)}, packed "
            f"{tuple(packed.shape)} {packed.dtype}, scale "
            f"{tuple(scale.shape)} (transposed={transposed}: packed "
            f"[N, K/2] + scale [G, N, 1], else [K/2, N] + [G, 1, N]; K / G "
            f"even)")
    return m, k, n, g


def dequant_f32(packed: torch.Tensor, scale: torch.Tensor,
                transposed: bool) -> torch.Tensor:
    """The f32 weight the kernel multiplies by, [K, N]: each sign-extended
    nibble in natural logical order times its group's scale (one rounded
    f32 product)."""
    g = scale.shape[0]
    if transposed:
        w = unpack_pairs(packed.t()).float()                 # [K, N]
        s = scale[:, :, 0]                                   # [G, N]
    else:
        w = unpack_pairs(packed).float()
        s = scale[:, 0, :]
    return w * s.float().repeat_interleave(w.shape[0] // g, dim=0)


def int4h_matmul_plain(x2d: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor,
                       transposed: bool) -> torch.Tensor:
    """Plain PyTorch version of K9, any device: x.float() @ the f32
    dequantized weight (f32 sums; TF32 must be off on a GPU), cast once."""
    return (x2d.float() @ dequant_f32(packed, scale, transposed)).to(
        x2d.dtype)


def int4h_matmul_2d(x2d: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Kernel K9: x2d [M, K] (bf16 or f32) @ dequant(packed) -> [M, N] in
    x's dtype."""
    m, k, n, g = _shapes(x2d, packed, scale, transposed)
    if x2d.device.type == "cpu":
        return int4h_matmul_plain(x2d, packed, scale, transposed)
    if not x2d.is_cuda:
        raise ValueError(f"int4h_matmul: unsupported device {x2d.device}")
    from medplib_tpu_torch.ops.cuda._build import check, load_library
    if x2d.dtype not in _X_DTYPES:
        raise TypeError(f"int4h_matmul: the CUDA kernel takes bf16 or f32 "
                        f"x, got {x2d.dtype}")
    dev = x2d.device
    for name, t, dt in (("x", x2d, x2d.dtype), ("packed", packed, torch.int8),
                        ("scale", scale, torch.float32)):
        _check_cuda(name, t, dt, tuple(t.shape), dev)
    gsize = k // g                   # the group map of the unpadded K
    kn = (1, 0) if transposed else (0, 1)
    if x2d.dtype == torch.bfloat16:
        # the tensor-core kernel takes any M, N and K itself; its copies
        # want 16-byte x rows (K % 8) and 4-byte weight rows, so only such
        # odd widths are padded (x and the weight, scale stays)
        xk, pk, _ = pad_operands(x2d, packed, None, 8,
                                 1 if transposed else 4, *kn, k_per_w_row=2)
        sk, n_run, k_run = scale, n, k
    else:
        # the f32-FMA kernel needs K % 32 and N % 16
        xk, pk, sk = pad_operands(x2d, packed, scale, 32, 16, *kn,
                                  scale_n_dim=1 if transposed else 2,
                                  k_per_w_row=2)
        n_run, k_run = pk.shape[kn[1]], xk.shape[1]
    out = torch.empty((m, n_run), device=dev, dtype=x2d.dtype)
    if m:
        lib = load_library()
        err = lib.int4h_matmul_launch(
            xk.data_ptr(), pk.data_ptr(), sk.data_ptr(), out.data_ptr(),
            m, n_run, k_run, xk.shape[1], pk.shape[1], g, gsize,
            _X_DTYPES[x2d.dtype], int(transposed),
            torch.cuda.current_stream(dev).cuda_stream)
        check(err, "int4h_matmul")
        int4h_matmul_2d.launches += 1
    return out if n_run == n else out[:, :n].contiguous()


int4h_matmul_2d.launches = 0


def _lead(x, packed, scale, transposed):
    y = int4h_matmul_2d(x.reshape(-1, x.shape[-1]).contiguous(), packed,
                        scale, transposed)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


def int4h_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [K/2, N], scale4h [G, 1, N])."""
    return _lead(x, w_q, scale, False)


def int4h_matmul_t(x: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(w_q [N, K/2], scale4h [G, N, 1]).T."""
    return _lead(x, w_q, scale, True)
