"""Grouped matmuls over expert weights (kernels K3 and K1), with the
group-aligned row layout they consume.

Counterpart of medplib_tpu/ops/pallas/gmm.py: `gmm` (the CUDA kernel
csrc/gmm.cu, replacing the Pallas `_kernel`: float, int8-weight and W8A8
experts, optionally transposed), `gmm_int4h` (csrc/gmm_int4h.cu, replacing
`_kernel_int4h`), `align_rows` / `align_groups`, `quantize_rows` and
`unpack_pairs` (plain torch).

On a CPU tensor `gmm` and `gmm_int4h` run their plain PyTorch versions,
`gmm_plain` and `gmm_int4h_plain`. On a CUDA tensor they launch their
kernels or raise.

What bounds the kernels on the H100, and what the designs do about it, is
noted at the top of each source (both compute bound at the flagship
prefill). On the tensor cores: `gmm` in W8A8 and `gmm_int4h` in W4A8 on
s8 mma.sync (csrc/s8_mma.cuh: exact s32 sums, the int4h nibbles widened
to s8 in registers, bit-equal to the plain versions), `gmm` on bf16 x
(int8-w and bf16 experts; f32 x against int8 experts is rounded to bf16
first, as the reference does) on bf16 mma.sync (csrc/int8w_mma.cuh), and
`gmm_int4h` on float x on K9's bf16 mma.sync tile grouped by tile_gid
(csrc/int4h_mma.cuh). The f32 pairs of `gmm` (csrc/gmm.cu) stay on f32
FMA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medplib_tpu_torch.ops.cuda.pad import pad_operands


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 activation quant: [..., K] -> (int8 [..., K],
    f32 scales [..., 1]). torch.round rounds half to even, like jnp.round;
    the 1e-12 floor and the +-127 clip are the reference's. The scale is
    amax * f32(1/127): XLA compiles the reference's `/ 127.0` so."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) * (1 / 127)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def unpack_pairs(p: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., R, C] -> int8 [..., 2R, C] in natural logical row
    order: row 2r is the low nibble of packed row r, row 2r+1 the high
    nibble, both sign-extended (shifts in int16, never on int8)."""
    p16 = p.to(torch.int16)
    lo = ((p16 << 12) >> 12).to(torch.int8)
    hi = (p16 >> 4).to(torch.int8)
    w = torch.stack([lo, hi], dim=-2)            # [..., R, 2, C]
    return w.reshape(p.shape[:-2] + (2 * p.shape[-2], p.shape[-1]))


def align_rows(expert_idx: torch.Tensor, num_experts: int, block_m: int):
    """The group-ALIGNED layout of routed rows: every m-tile of `block_m`
    rows belongs to one expert, gap rows are left out. expert_idx [S] ->
    (dest [S] row of each routed row, tile_gid [Sp // block_m] int32, Sp).
    No host sync: Sp follows from S, E and block_m alone.

    E = 2 packs two-ended as the reference does: group 0 grows from row 0,
    group 1 descends from row Sp-1, with Sp = (ceil(S / bm) + 1) * bm, and a
    tile belongs to group 1 iff tile_end > Sp - n1. E > 2: groups in order,
    each rounded up to whole tiles, Sp = (S // bm + E) * bm."""
    s = expert_idx.shape[0]
    dev = expert_idx.device
    idx = expert_idx.long()
    if num_experts == 2:
        csum = torch.cumsum(F.one_hot(idx, num_experts), dim=0)  # [S, 2]
        ranks = torch.gather(csum, 1, idx[:, None])[:, 0] - 1
        sp = ((s + block_m - 1) // block_m + 1) * block_m
        dest = torch.where(idx == 0, ranks, sp - 1 - ranks)
        tile_end = (torch.arange(sp // block_m, device=dev) + 1) * block_m
        tile_gid = (tile_end > sp - csum[-1, 1]).to(torch.int32)
        return dest, tile_gid, sp
    # each row's rank in its group, in row order: a stable sort by expert
    # (the cumsum of [S, E] one-hots gives the same ranks, but as an
    # outer-dim scan it took ~0.1 s a layer at S = 267 k rows, E = 64, on
    # the H100); the group bounds by a search of the sorted ids (bincount
    # reads the ids' range on the host)
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    bounds = torch.searchsorted(
        sorted_idx, torch.arange(num_experts + 1, device=dev))
    first = bounds[:-1]
    group_sizes = bounds[1:] - first
    ranks = torch.empty_like(idx)
    ranks[order] = torch.arange(s, device=dev) - first[sorted_idx]
    sp = (s // block_m + num_experts) * block_m
    aligned = (group_sizes + block_m - 1) // block_m * block_m
    ends = torch.cumsum(aligned, dim=0)
    offs = ends - aligned
    dest = offs[idx] + ranks
    tile_start = torch.arange(sp // block_m, device=dev) * block_m
    tile_gid = (tile_start[:, None] >= ends[None, :]).sum(1)
    tile_gid = tile_gid.clamp(max=num_experts - 1).to(torch.int32)
    return dest, tile_gid, sp


def align_groups(xs: torch.Tensor, expert_idx: torch.Tensor,
                 num_experts: int, block_m: int):
    """Scatter routed rows into the group-aligned buffer of `align_rows`,
    gap rows zero. xs [S, K]; expert_idx [S] -> (x_al [Sp, K], dest [S]
    row of each token, tile_gid [Sp // block_m] int32)."""
    dest, tile_gid, sp = align_rows(expert_idx, num_experts, block_m)
    x_al = xs.new_zeros((sp, xs.shape[1]))
    x_al[dest] = xs
    return x_al, dest, tile_gid


def gmm_int4h_plain(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, tile_gid: torch.Tensor,
                    a_scale: torch.Tensor | None = None,
                    block_m: int = 512, block_n: int = 512,
                    out_dtype: torch.dtype | None = None,
                    allow_pad: bool = True,
                    block_k: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1, any device. A8 (int8 x): the two
    half-K products are integer sums below 2^24 (127 * 8 * K/2 for
    K/2 <= 16384), so float32 products of the integer operands are exact
    (TF32 must be off on a GPU); a missing a_scale is ones. bf16 mode: x
    rounded to bf16, exact products, f32 sums. Epilogue order as the
    kernel: (lo * s0 + hi * s1) * a_scale in f32, cast to out_dtype
    (default bf16 for int8 x, else x.dtype). block_n, allow_pad and
    block_k are the TPU kernel's tiling knobs (see `gmm_int4h`)."""
    sp, k = x.shape
    e, _, n = packed.shape
    half = k // 2
    int8_x = x.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.bfloat16 if int8_x else x.dtype
    xf = x.float() if int8_x else x.to(torch.bfloat16).float()
    rows_gid = tile_gid.long().repeat_interleave(block_m)
    out = torch.zeros((sp, n), dtype=torch.float32, device=x.device)
    for g in range(e):
        sel = rows_gid == g
        if not bool(sel.any()):
            continue
        w = unpack_pairs(packed[g]).float()                  # [K, N]
        xg = xf[sel]
        lo = xg[:, :half] @ w[:half]
        hi = xg[:, half:] @ w[half:]
        y = lo * scale[g, 0].float() + hi * scale[g, 1].float()
        if int8_x and a_scale is not None:
            y = y * a_scale[sel].float()
        out[sel] = y
    return out.to(out_dtype)


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


_KERNEL_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def gmm_plain(x: torch.Tensor, w: torch.Tensor, tile_gid: torch.Tensor,
              w_scale: torch.Tensor | None = None,
              a_scale: torch.Tensor | None = None, block_m: int = 512,
              out_dtype: torch.dtype | None = None,
              transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3, any device. W8A8 (int8 x): the sums are
    taken in float64, where every partial sum of int8 products is an exact
    integer, then rounded to f32 as the kernel converts its s32 sum.
    int8-w: x rounded to bf16, exact products, f32 sums. float: the
    operands' own products, f32 sums (TF32 must be off on a GPU).
    Epilogue in the kernel's order: acc * w_scale (int8 w only), then
    * a_scale (int8 x only), each product rounded in f32."""
    sp = x.shape[0]
    n = w.shape[1] if transposed else w.shape[2]
    int8_x, int8_w = x.dtype == torch.int8, w.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.bfloat16 if int8_x else x.dtype
    if int8_x:
        xf = x.double()
    elif int8_w:
        xf = x.to(torch.bfloat16).float()
    else:
        xf = x.float()
    rows_gid = tile_gid.long().repeat_interleave(block_m)
    out = torch.zeros((sp, n), dtype=torch.float32, device=x.device)
    for g in range(w.shape[0]):
        sel = rows_gid == g
        if not bool(sel.any()):
            continue
        wg = w[g].t() if transposed else w[g]
        y = (xf[sel] @ wg.to(xf.dtype)).float()
        if int8_w and w_scale is not None:
            y = y * w_scale[g].float()
        if int8_x and a_scale is not None:
            y = y * a_scale[sel].float()
        out[sel] = y
    return out.to(out_dtype)


def gmm(x: torch.Tensor, w: torch.Tensor, tile_gid: torch.Tensor,
        w_scale: torch.Tensor | None = None,
        a_scale: torch.Tensor | None = None, block_m: int = 512,
        block_n: int = 512, out_dtype: torch.dtype | None = None,
        allow_pad: bool = True, block_k: int | None = None,
        transposed: bool = False) -> torch.Tensor:
    """Grouped matmul over group-aligned rows (kernel K3).

    x [Sp, K]: float, or int8 with a_scale [Sp, 1] f32 (W8A8); w [E, K, N]
    float or int8 with w_scale [E, 1, N] f32 per channel, or [E, N, K]
    with `transposed` (w_scale still channel-last); tile_gid [Sp // block_m]
    int32. -> [Sp, N] in out_dtype (default bf16 for int8 x, else x.dtype).
    block_n, block_k and allow_pad are the TPU kernel's tiling knobs: they
    are accepted and change nothing (the card's kernel zero-pads K and N to
    multiples of 16 only where they are not: ops/cuda/pad.py)."""
    sp, k = x.shape
    e, kw, n = (w.shape[0], w.shape[2], w.shape[1]) if transposed \
        else tuple(w.shape)
    if kw != k:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (transposed={transposed})")
    if sp % block_m or tuple(tile_gid.shape) != (sp // block_m,):
        raise ValueError(f"Sp={sp} must be a multiple of block_m={block_m} "
                         f"with one tile_gid per tile")
    int8_x, int8_w = x.dtype == torch.int8, w.dtype == torch.int8
    if int8_x and not int8_w:
        raise TypeError("int8 x (W8A8) needs int8 w")
    if w_scale is not None and tuple(w_scale.shape) != (e, 1, n):
        raise ValueError(f"w_scale must be channel-last {(e, 1, n)}, got "
                         f"{tuple(w_scale.shape)}")
    if out_dtype is None:
        out_dtype = torch.bfloat16 if int8_x else x.dtype
    if x.device.type == "cpu":
        return gmm_plain(x, w, tile_gid, w_scale, a_scale, block_m,
                         out_dtype, transposed)
    if not x.is_cuda:
        raise ValueError(f"gmm: unsupported device {x.device}")

    from medplib_tpu_torch.ops.cuda._build import check, load_library
    dev = x.device
    if block_m % 16:
        raise ValueError(f"the CUDA kernel needs block_m % 16 == 0 "
                         f"(block_m={block_m})")
    if x.dtype not in _KERNEL_DTYPES or w.dtype not in _KERNEL_DTYPES \
            or out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernel takes int8 / bf16 / f32 operands "
                        f"and a bf16 / f32 output (x {x.dtype}, w {w.dtype}, "
                        f"out {out_dtype})")
    _check_cuda("x", x, x.dtype, (sp, k), dev)
    if int8_w and x.dtype == torch.float32:
        # the reference rounds x to bf16 against an int8 weight; the
        # tensor-core kernel takes it so (the ICL path's x is bf16 already)
        x = x.to(torch.bfloat16)
    _check_cuda("w", w, w.dtype, tuple(w.shape), dev)
    _check_cuda("tile_gid", tile_gid, torch.int32, (sp // block_m,), dev)
    ws = w_scale if int8_w else None
    a_s = a_scale if int8_x else None
    if ws is not None:
        _check_cuda("w_scale", ws, torch.float32, (e, 1, n), dev)
    if a_s is not None:
        _check_cuda("a_scale", a_s, torch.float32, (sp, 1), dev)
    # the kernel's 16-byte loads want K % 16 == 0 and N % 16 == 0
    kn = (2, 1) if transposed else (1, 2)
    x, w, ws = pad_operands(x, w, ws, 16, 16, *kn)
    n_run = w.shape[kn[1]]
    out = torch.empty((sp, n_run), device=dev, dtype=out_dtype)
    if sp and n:
        lib = load_library()
        err = lib.gmm_launch(
            x.data_ptr(), w.data_ptr(), tile_gid.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            a_s.data_ptr() if a_s is not None else None, out.data_ptr(),
            sp, x.shape[1], n_run, block_m, 64 if block_m % 64 == 0 else 16,
            _KERNEL_DTYPES[x.dtype], _KERNEL_DTYPES[w.dtype],
            int(transposed), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        check(err, "gmm")
        gmm.launches += 1
    return out if n_run == n else out[:, :n].contiguous()


gmm.launches = 0


def gmm_int4h(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
              tile_gid: torch.Tensor, a_scale: torch.Tensor | None = None,
              block_m: int = 512, block_n: int = 512,
              out_dtype: torch.dtype | None = None, allow_pad: bool = True,
              block_k: int | None = None) -> torch.Tensor:
    """Grouped matmul over int4h expert weights (kernel K1).

    x [Sp, K] group-aligned rows: int8 with a_scale [Sp, 1] f32 (W4A8; a
    missing a_scale is ones, as in the reference), or float (rounded to
    bf16 for the products, f32 accumulation); packed [E, K/2, N] int8
    pairs layout; scale [E, 2, 1, N] f32 per-half scales; tile_gid
    [Sp // block_m] int32. -> [Sp, N] in out_dtype (default bf16 for int8
    x, else x.dtype), the f32 result cast once.

    block_n, allow_pad and block_k are the TPU kernel's tiling knobs:
    accepted and ignored here (the card's kernels tile by their own
    shapes and zero-pad N to a multiple of 16 where it is not: ops/cuda/
    pad.py). None of them changes an A8 result (exact integer sums). In
    the float mode block_k moves the reference's f32 summation order (it
    sets the K blocks the Pallas kernel accumulates one after another);
    the port's kernel sums in its own order, within the same f32
    summation bound."""
    sp, k = x.shape
    e, k2, n = packed.shape
    if 2 * k2 != k or tuple(scale.shape) != (e, 2, 1, n):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)}")
    if k2 % 128:
        raise ValueError("int4h gmm needs K/2 % 128 == 0")
    if sp % block_m or tuple(tile_gid.shape) != (sp // block_m,):
        raise ValueError(f"Sp={sp} must be a multiple of block_m={block_m} "
                         f"with one tile_gid per tile")
    int8_x = x.dtype == torch.int8
    if out_dtype is None:
        out_dtype = torch.bfloat16 if int8_x else x.dtype
    if x.device.type == "cpu":
        return gmm_int4h_plain(x, packed, scale, tile_gid, a_scale, block_m,
                               block_n, out_dtype, allow_pad, block_k)
    if not x.is_cuda:
        raise ValueError(f"gmm_int4h: unsupported device {x.device}")

    from medplib_tpu_torch.ops.cuda._build import check, load_library
    dev = x.device
    if block_m % 16:
        raise ValueError(f"the CUDA kernel needs block_m % 16 == 0 "
                         f"(block_m={block_m})")
    xk = x if int8_x else x.to(torch.bfloat16)
    a_s = a_scale if int8_x else None
    _check_cuda("x", xk, xk.dtype, (sp, k), dev)
    _check_cuda("packed", packed, torch.int8, (e, k2, n), dev)
    _check_cuda("scale", scale, torch.float32, (e, 2, 1, n), dev)
    _check_cuda("tile_gid", tile_gid, torch.int32, (sp // block_m,), dev)
    if a_s is not None:
        _check_cuda("a_scale", a_s, torch.float32, (sp, 1), dev)
    # both tensor-core kernels guard N at 16 (16-byte weight copies)
    xk, pk, sk = pad_operands(xk, packed, scale, 1, 16, 1, 2)
    n_run = pk.shape[2]
    # A8 rounds to bf16 in its epilogue; everything else leaves f32
    out_bf16 = int8_x and out_dtype == torch.bfloat16
    out = torch.empty((sp, n_run), device=dev,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    lib = load_library()
    err = lib.gmm_int4h_launch(
        xk.data_ptr(), pk.data_ptr(), sk.data_ptr(),
        tile_gid.data_ptr(), a_s.data_ptr() if a_s is not None else None,
        out.data_ptr(), sp, k, n_run, block_m, int(int8_x), int(out_bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gmm_int4h")
    gmm_int4h.launches += 1
    if n_run != n:
        out = out[:, :n].contiguous()
    return out.to(out_dtype)


gmm_int4h.launches = 0
