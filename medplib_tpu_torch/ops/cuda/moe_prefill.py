"""The MoE layer's prefill activations in int8 around the grouped matmuls
(K1 / K3 under W4A8 / W8A8): the three passes of csrc/moe_prefill_quant.cu.

- `moe_dispatch_quant`: each routed token's row quantized once
  (`quantize_rows`' numerics) and its int8 row and scale written to each of
  its k rows of the group-aligned buffer; gap rows are zeros, as
  quantizing the zero-filled buffer gives. Gate and up read the result.
- `moe_swiglu_quant`: the bf16 gate and up products to the down
  projection's int8 rows and scales in one pass (`silu` rounded op by op,
  the product unrounded in f32, then the row quantization).
- `moe_topk_combine`: each token's k output rows, weighted in f32 and
  summed in a fixed order, rounded once.

They replace no Pallas kernel (the JAX package leaves these ops to XLA's
fusions around its gmm). On a CPU tensor each wrapper runs its plain
version, the PyTorch sequence `ops/moe.py` ran before them; on a CUDA
tensor it launches its kernel (one launch, counted in `.launches`) or
raises. What bounds them (bytes) and how each reads and writes a row once
is noted at the top of the source.
"""

from __future__ import annotations

import torch

from medplib_tpu_torch.ops.activations import silu
from medplib_tpu_torch.ops.cuda.gmm import _check_cuda, quantize_rows


def _launch(fn, t: torch.Tensor, *args) -> None:
    """One launch of fn's kernel (`<name>_launch` in the library) on t's
    current stream; raises on a launch error, counts it."""
    from medplib_tpu_torch.ops.cuda._build import check, load_library
    err = getattr(load_library(), fn.__name__ + "_launch")(
        *args, torch.cuda.current_stream(t.device).cuda_stream)
    check(err, fn.__name__)
    fn.launches += 1


def moe_dispatch_quant_plain(xs: torch.Tensor, dest: torch.Tensor, sp: int,
                             k: int):
    """Plain version: each token's row gathered k times into a zero-filled
    [sp, H] buffer at `dest`, then every aligned row quantized."""
    x_al = xs.new_zeros((sp, xs.shape[1]))
    x_al[dest.long()] = xs if k == 1 else xs.repeat_interleave(k, dim=0)
    return quantize_rows(x_al)


def moe_dispatch_quant(xs: torch.Tensor, dest: torch.Tensor, sp: int,
                       k: int):
    """xs [S, H] (bf16 or f32) routed k times a token: dest [S·k] the
    aligned row of token t's j-th route at t·k + j (distinct rows below
    sp). -> (int8 [sp, H], f32 row scales [sp, 1]): what `quantize_rows`
    gives on the aligned buffer of xs' rows, each token quantized once."""
    s, h = xs.shape
    if tuple(dest.shape) != (s * k,):
        raise ValueError(f"dest must be [S·k] = [{s * k}], got "
                         f"{tuple(dest.shape)}")
    if xs.device.type == "cpu":
        return moe_dispatch_quant_plain(xs, dest, sp, k)
    if not xs.is_cuda:
        raise ValueError(f"moe_dispatch_quant: unsupported device "
                         f"{xs.device}")
    if xs.dtype not in (torch.bfloat16, torch.float32) or h % 16 \
            or not 0 < k <= 128:
        raise ValueError(f"the CUDA kernel takes bf16 / f32 rows of H % 16 "
                         f"== 0 and 1 <= k <= 128 (x {xs.dtype} [{s}, {h}],"
                         f" k={k})")
    dev = xs.device
    _check_cuda("xs", xs, xs.dtype, (s, h), dev)
    d32 = dest.to(torch.int32).contiguous()
    # the routed row in each aligned row, -1 in the gaps
    src = torch.full((sp,), -1, dtype=torch.int32, device=dev)
    src[dest.long()] = torch.arange(s * k, dtype=torch.int32, device=dev)
    xq = torch.empty((sp, h), dtype=torch.int8, device=dev)
    scale = torch.empty((sp, 1), dtype=torch.float32, device=dev)
    _launch(moe_dispatch_quant, xs, xs.data_ptr(), d32.data_ptr(),
            src.data_ptr(), xq.data_ptr(), scale.data_ptr(), s, h, k, sp,
            int(xs.dtype == torch.float32))
    return xq, scale


moe_dispatch_quant.launches = 0


def moe_swiglu_quant_plain(h1: torch.Tensor, h2: torch.Tensor):
    """Plain version: silu(h1) in h1's dtype, its product with h2 in f32
    (unrounded, as the compiled reference feeds its activation quant),
    then quantize_rows."""
    return quantize_rows(silu(h1).float() * h2.float())


def moe_swiglu_quant(h1: torch.Tensor, h2: torch.Tensor):
    """h1, h2 [R, M]: the gate and up products of the aligned rows. ->
    (int8 [R, M], f32 row scales [R, 1]), the down projection's input.
    On the card h1 and h2 are bf16 (the int8-x grouped matmuls' output)
    and M % 8 == 0, M <= 16384."""
    if h1.shape != h2.shape or h1.dim() != 2:
        raise ValueError(f"h1 {tuple(h1.shape)} and h2 {tuple(h2.shape)} "
                         f"must be one [R, M] shape")
    if h1.device.type == "cpu":
        return moe_swiglu_quant_plain(h1, h2)
    if not h1.is_cuda:
        raise ValueError(f"moe_swiglu_quant: unsupported device {h1.device}")
    r, m = h1.shape
    if m % 8 or m > 16384:
        raise ValueError(f"the CUDA kernel takes M % 8 == 0, M <= 16384 "
                         f"(M={m})")
    dev = h1.device
    _check_cuda("h1", h1, torch.bfloat16, (r, m), dev)
    _check_cuda("h2", h2, torch.bfloat16, (r, m), dev)
    q = torch.empty((r, m), dtype=torch.int8, device=dev)
    scale = torch.empty((r, 1), dtype=torch.float32, device=dev)
    _launch(moe_swiglu_quant, h1, h1.data_ptr(), h2.data_ptr(),
            q.data_ptr(), scale.data_ptr(), r, m)
    return q, scale


moe_swiglu_quant.launches = 0


def moe_topk_combine_plain(y_al: torch.Tensor, dest: torch.Tensor,
                           w: torch.Tensor, out_dtype: torch.dtype):
    """Plain version: the rows at dest in f32, times their weights, summed
    over each token's k (PyTorch's reduction order), cast once."""
    s, k = w.shape
    y = y_al[dest.long()].float().reshape(s, k, -1) * w.float()[..., None]
    return y.sum(1).to(out_dtype)


def moe_topk_combine(y_al: torch.Tensor, dest: torch.Tensor,
                     w: torch.Tensor, out_dtype: torch.dtype):
    """y_al [Sp, H] (bf16 or f32) the aligned rows' outputs; dest [S·k]
    the aligned row of token t's j-th route at t·k + j; w [S, k] the
    combine weights. -> [S, H] out_dtype: sum over j of f32(y_al[dest]) ·
    w, on the card in the order j = 0 .. k-1 from 0 (the plain version
    sums in PyTorch's order: f32 sums in another order)."""
    s, k = w.shape
    if tuple(dest.shape) != (s * k,) or y_al.dim() != 2:
        raise ValueError(f"dest {tuple(dest.shape)} must be [S·k] = "
                         f"[{s * k}] and y_al [Sp, H]")
    if y_al.device.type == "cpu":
        return moe_topk_combine_plain(y_al, dest, w, out_dtype)
    if not y_al.is_cuda:
        raise ValueError(f"moe_topk_combine: unsupported device "
                         f"{y_al.device}")
    floats = (torch.bfloat16, torch.float32)
    sp, h = y_al.shape
    if y_al.dtype not in floats or out_dtype not in floats or h % 8:
        raise ValueError(f"the CUDA kernel takes bf16 / f32 rows of H % 8 "
                         f"== 0 (y_al {y_al.dtype} [{sp}, {h}], out "
                         f"{out_dtype})")
    dev = y_al.device
    _check_cuda("y_al", y_al, y_al.dtype, (sp, h), dev)
    d32 = dest.to(torch.int32).contiguous()
    wf = w.float().contiguous()
    out = torch.empty((s, h), dtype=out_dtype, device=dev)
    _launch(moe_topk_combine, y_al, y_al.data_ptr(), d32.data_ptr(),
            wf.data_ptr(), out.data_ptr(), s, h, k,
            int(y_al.dtype == torch.float32), int(out_dtype == torch.float32))
    return out


moe_topk_combine.launches = 0
