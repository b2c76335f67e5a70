"""Fused decode-step MoE FFN over int4h experts (kernel K2).

Counterpart of medplib_tpu/ops/pallas/moe_decode.py: the routed SwiGLU
expert FFN of one decode step, `moe_ffn_decode_int4h` (the CUDA kernels of
csrc/moe_decode_int4h.cu, replacing the Pallas `_kernel`), with
`fused_decode_eligible` and `_pick_bn`.

The JAX kernel addresses the whole [L*E, ...] stack with a layer offset,
a workaround for XLA's slice copies; a per-layer [E, ...] view is free in
torch, so this takes the layer's experts directly.

On a CPU tensor the wrapper runs `moe_ffn_decode_int4h_plain`; on a CUDA
tensor it launches the kernels (five launches, one counted call) or
raises. What bounds the kernel (HBM bandwidth: every expert byte of the
layer is read each step) and what the design does about it is noted at
the top of csrc/moe_decode_int4h.cu.
"""

from __future__ import annotations

import torch

from medplib_tpu_torch.ops.cuda.gmm import quantize_rows, unpack_pairs
from medplib_tpu_torch.ops.activations import silu


def _pick_bn(m2: int, cap: int = 512) -> int:
    """Largest multiple of 128 <= cap dividing M/2 (0 if none): the block
    of M over which the A8 activation is quantized per row."""
    for mult in range(min(cap, m2) // 128, 0, -1):
        if m2 % (128 * mult) == 0:
            return 128 * mult
    return 0


def fused_decode_eligible(experts, num_experts: int) -> bool:
    """True when one layer's experts ({gate,up,down}_proj with kernels
    [E, K/2, N] int8 and per-half scale4h [E, 2, 1, N]) have the shapes
    the fused decode kernel streams."""
    try:
        gp, up, dp = (experts[n] for n in ("gate_proj", "up_proj",
                                           "down_proj"))
        for n in (gp, up, dp):
            if "scale4h" not in n or n["scale4h"].shape[-3] != 2:
                return False
            if n["kernel"].dtype != torch.int8 or n["kernel"].dim() != 3:
                return False
        k2g, m = gp["kernel"].shape[-2], gp["kernel"].shape[-1]
        if tuple(up["kernel"].shape[-2:]) != (k2g, m):
            return False
        m2, h = dp["kernel"].shape[-2], dp["kernel"].shape[-1]
        if m != 2 * m2 or h != 2 * k2g:
            return False
        return _pick_bn(m2) != 0 and k2g % 8 == 0 and h % 128 == 0
    except (KeyError, AttributeError, TypeError):
        return False


def _block_n(m2: int, block_n: int | None) -> int:
    """The act-quant block of M: block_n, or _pick_bn(M/2), dividing M/2
    (the reference's assert)."""
    bn = block_n or _pick_bn(m2)
    if not bn or m2 % bn:
        raise ValueError(f"block_n={bn} must divide M/2={m2}")
    return bn


def moe_ffn_decode_int4h_plain(x: torch.Tensor, experts,
                               route_idx: torch.Tensor,
                               route_gate: torch.Tensor, num_experts: int,
                               block_n: int | None = None,
                               int8_x: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2, any device, in the kernel's order of
    operations. A8 partial sums are integers below 2^24 (127 * 8 * H/2 for
    gate/up, 127 * 8 * bn for down), so float32 products of the integer
    operands are exact (TF32 must be off on a GPU)."""
    b, h = x.shape
    h2 = h // 2
    idx = route_idx.reshape(b, -1)            # [B, topk]
    gate = route_gate.float().reshape(b, -1)
    gp, up, dp = (experts[n] for n in ("gate_proj", "up_proj", "down_proj"))
    m2 = gp["kernel"].shape[-1] // 2
    bn = _block_n(m2, block_n)
    n_j = m2 // bn
    if int8_x:
        xq, xs = quantize_rows(x)
        xf = xq.float()
    else:
        xf = x.to(torch.bfloat16).float()
    acc = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    for e in range(num_experts):
        def gu(node):
            w = unpack_pairs(node["kernel"][e]).float()          # [H, M]
            s = node["scale4h"][e].float()                       # [2, 1, M]
            r = xf[:, :h2] @ w[:h2] * s[0] + xf[:, h2:] @ w[h2:] * s[1]
            return r * xs if int8_x else r
        g, u = gu(gp), gu(up)
        mask = torch.where(idx == e, gate, torch.zeros_like(gate)).sum(1)
        act = silu(g) * u * mask[:, None]
        wd = unpack_pairs(dp["kernel"][e]).float()               # [M, H]
        ds = dp["scale4h"][e].float()                            # [2, 1, H]
        for j in range(n_j):
            for nh in range(2):
                c = nh * n_j + j
                blk = act[:, c * bn:(c + 1) * bn]
                wblk = wd[c * bn:(c + 1) * bn]
                if int8_x:
                    q, sc = quantize_rows(blk)
                    acc = acc + q.float() @ wblk * sc * ds[nh]
                else:
                    acc = acc + blk.to(torch.bfloat16).float() @ wblk * ds[nh]
    return acc.to(x.dtype)


def moe_ffn_decode_int4h(x: torch.Tensor, experts, route_idx: torch.Tensor,
                         route_gate: torch.Tensor, num_experts: int,
                         block_n: int | None = None,
                         int8_x: bool = False) -> torch.Tensor:
    """x [B, H]; experts: one layer's int4h(G=2) nodes (kernels [E, K/2, N]
    int8, scale4h [E, 2, 1, N] f32); route_idx [B] top-1 expert per row,
    or [B, k] k distinct experts a row; route_gate [B] / [B, k] their
    combine weights. -> routed MoE output [B, H] x.dtype: the sum of each
    row's experts' gated outputs (every expert is computed for every row
    and masked, so k experts a row cost what one does).

    block_n: the block of M over which A8 quantizes the activation per row
    (default `_pick_bn(M/2)`; it must divide M/2), as in the reference;
    the card's kernel takes any multiple of 128. int8_x (A8, the serving
    default through ops/moe.py): x quantized per row (`quantize_rows`;
    on the card by the kernel's first launch), the activation per row per
    bn-block, all products s8 x s8; off (the default here, as in the
    reference): bf16 x and a bf16 activation."""
    if not fused_decode_eligible(experts, num_experts):
        raise ValueError("experts do not have the fused-decode int4h shapes")
    b, h = x.shape
    gp, up, dp = (experts[n] for n in ("gate_proj", "up_proj", "down_proj"))
    m = gp["kernel"].shape[-1]
    bn = _block_n(m // 2, block_n)
    if x.device.type == "cpu":
        return moe_ffn_decode_int4h_plain(x, experts, route_idx, route_gate,
                                          num_experts, bn, int8_x)
    if not x.is_cuda:
        raise ValueError(f"moe_ffn_decode_int4h: unsupported device "
                         f"{x.device}")

    from medplib_tpu_torch.ops.cuda._build import check, load_library
    from medplib_tpu_torch.ops.cuda.gmm import _check_cuda
    dev = x.device
    e = num_experts
    if bn % 128:
        raise ValueError(f"the CUDA kernel tiles block_n in 128-deep steps "
                         f"(block_n={bn})")
    if b > 64:
        # the kernel takes at most 64 rows; rows are independent (the act
        # quant is per row and per bn block), so launch once per 64 rows
        return torch.cat([
            moe_ffn_decode_int4h(x[i:i + 64], experts, route_idx[i:i + 64],
                                 route_gate[i:i + 64], num_experts, bn,
                                 int8_x)
            for i in range(0, b, 64)])
    bp = 16 if b <= 16 else 32 if b <= 32 else 64
    xin = x if x.dtype in (torch.bfloat16, torch.float32) else x.float()
    idx = route_idx.to(torch.int32).reshape(b, -1).contiguous()
    gate = route_gate.float().reshape(b, -1).contiguous()
    topk = idx.shape[1]
    for name, node, shape in (("gate_proj", gp, (e, h // 2, m)),
                              ("up_proj", up, (e, h // 2, m)),
                              ("down_proj", dp, (e, m // 2, h))):
        _check_cuda(f"{name}.kernel", node["kernel"], torch.int8, shape, dev)
        _check_cuda(f"{name}.scale4h", node["scale4h"], torch.float32,
                    (e, 2, 1, shape[2]), dev)
    _check_cuda("x", xin, xin.dtype, (b, h), dev)
    _check_cuda("route_idx", idx, torch.int32, (b, topk), dev)
    _check_cuda("route_gate", gate, torch.float32, (b, topk), dev)
    # one scratch buffer, cut into the kernels' operands (256-byte aligned):
    # the padded x (int8 + row scales, or bf16), the gate / up sums, the
    # activation (int8 + per-row-per-block scales, or bf16) and one f32
    # partial of the down product per (e, j, nh)
    esz = 1 if int8_x else 2
    sizes = (bp * h * esz, bp * 4, e * 2 * bp * m * 4, e * bp * m * esz,
             e * bp * (m // bn) * 4, e * (m // bn) * bp * h * 4)
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 256) * 256
    work = torch.empty((total,), dtype=torch.uint8, device=dev)
    xk, xs, gu, act_q, act_s, part = (work.data_ptr() + o for o in offs)
    f32 = xin.dtype == torch.float32      # x and out in f32, else bf16
    out = torch.empty((b, h), device=dev, dtype=xin.dtype)
    lib = load_library()
    err = lib.moe_decode_int4h_launch(
        xin.data_ptr(), idx.data_ptr(), gate.data_ptr(),
        gp["kernel"].data_ptr(), gp["scale4h"].data_ptr(),
        up["kernel"].data_ptr(), up["scale4h"].data_ptr(),
        dp["kernel"].data_ptr(), dp["scale4h"].data_ptr(),
        xk, xs, gu, act_q, act_s, part, out.data_ptr(), b, bp, h, m, e, bn,
        topk, int(int8_x), int(f32),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "moe_ffn_decode_int4h")
    moe_ffn_decode_int4h.launches += 1
    return out if out.dtype == x.dtype else out.to(x.dtype)


moe_ffn_decode_int4h.launches = 0
