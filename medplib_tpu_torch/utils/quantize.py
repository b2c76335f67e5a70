"""Weight-only int8 / int4h quantization for inference
(medplib_tpu/utils/quantize.py), byte-compatible with the JAX package:

- int8: {"kernel": int8, "scale": f32} per output channel, symmetric.
- int4h, the "interleaved pairs" layout: logical reduction row 2r is the
  LOW nibble of packed row r and row 2r+1 its HIGH nibble, both
  sign-extended; {"kernel": packed int8, "scale4h": f32} with `groups`
  contiguous logical scale groups along the reduction axis.
- int4 "block" (int4_scheme="block"): the same nibble packing with one
  f32 scale per `block` reduction rows, {"kernel", "scale4"}; finer
  scales, no fused matmul (train/lora.dequant_kernel materializes it).

Also the int4h matmuls of the 2D int4h linears (`int4h_matmul(_t)`: one
pair of products per scale group, in the activation dtype, as the JAX
package's XLA composition), the W8A8 prefill switch (`dynamic_act_quant`)
and its matmul.
Quantizers work one leading-dim slice at a time so float32 temporaries
stay one layer in size, and (like the JAX quantizers, which donate their
input) they do not keep the float tree alive.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Sequence

import torch

from medplib_tpu_torch.train.lora import TRANSPOSED_KERNELS
from medplib_tpu_torch.utils import profiling

SKIP_MODULES = ("sam", "clip", "text_hidden_fcs", "region_fea_adapter",
                "mask_encoder", "mm_token_compressor", "router",
                "coefficient", "embed_tokens", "norm", "input_layernorm",
                "post_attention_layernorm")


def _map_leading(fn, kernel: torch.Tensor):
    """Apply a 2D quantizer over stacked leading dims one slice at a time."""
    lead = kernel.shape[:-2]
    if not lead:
        return fn(kernel)
    flat = kernel.reshape((-1,) + kernel.shape[-2:])
    outs = [fn(flat[i]) for i in range(flat.shape[0])]
    q = torch.stack([o[0] for o in outs])
    s = torch.stack([o[1] for o in outs])
    return (q.reshape(lead + q.shape[1:]), s.reshape(lead + s.shape[1:]))


@torch.no_grad()
def _quantize_kernel(kernel: torch.Tensor, out_axis: int):
    """int8 per-output-channel: -> (int8 kernel, f32 scale with the
    reduction axis kept as size 1)."""
    core_out_axis = out_axis - (kernel.dim() - 2)   # 0 or 1 in a 2D slice

    def one(k2):
        kf = k2.float()
        absmax = kf.abs().amax(dim=1 - core_out_axis, keepdim=True)
        scale = absmax * (1 / 127)      # XLA's form of `/ 127.0`
        q = torch.round(kf / scale.clamp(min=1e-12)).clamp(-127, 127)
        return q.to(torch.int8), scale

    return _map_leading(one, kernel)


def _pack_pairs(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 nibble planes in [-8, 7] -> one byte (lo | hi << 4)."""
    return ((lo.to(torch.int16) & 15) | (hi.to(torch.int16) << 4)).to(
        torch.int8)


@torch.no_grad()
def _quantize_kernel4h(kernel: torch.Tensor, transposed: bool, groups: int):
    """int4 interleaved-pairs packing. Normal [.., K, N] -> packed
    [.., K/2, N] + scale4h [.., G, 1, N]; transposed [.., N, K] -> packed
    [.., N, K/2] + scale4h [.., G, N, 1]."""
    assert groups % 2 == 0, "groups must be even (pair-aligned boundaries)"

    def one(k2):
        w = k2.float()
        if transposed:
            o, i = w.shape
            g = groups if i % groups == 0 else 2
            wb = w.reshape(o, g, i // g)
            scale = wb.abs().amax(dim=-1, keepdim=True) * (1 / 7)
            q = torch.round(wb / scale.clamp(min=1e-12)).clamp(-8, 7).to(
                torch.int8).reshape(o, i)
            packed = _pack_pairs(q[:, 0::2], q[:, 1::2])
            scale = scale.permute(1, 0, 2)          # [O, G, 1] -> [G, O, 1]
        else:
            i, o = w.shape
            g = groups if i % groups == 0 else 2
            wb = w.reshape(g, i // g, o)
            scale = wb.abs().amax(dim=-2, keepdim=True) * (1 / 7)
            q = torch.round(wb / scale.clamp(min=1e-12)).clamp(-8, 7).to(
                torch.int8).reshape(i, o)
            packed = _pack_pairs(q[0::2], q[1::2])
            scale = scale.reshape(g, 1, o)
        return packed.contiguous(), scale.contiguous()

    return _map_leading(one, kernel)


@torch.no_grad()
def _quantize_kernel4(kernel: torch.Tensor, transposed: bool, block: int):
    """Blockwise int4 along the reduction axis, nibble-packed (even rows
    low, odd rows high). Normal [.., in, out] -> packed [.., in/2, out] +
    scale4 [.., nb, 1, out]; transposed [.., out, in] -> packed
    [.., out, in/2] + scale4 [.., out, nb, 1]. A `block` that does not
    divide `in` gives one block."""

    def one(k2):
        w = k2.float()
        if transposed:
            o, i = w.shape
            b = block if i % block == 0 else i
            wb = w.reshape(o, i // b, b)
            scale = wb.abs().amax(dim=-1, keepdim=True) * (1 / 7)
        else:
            i, o = w.shape
            b = block if i % block == 0 else i
            wb = w.reshape(i // b, b, o)
            scale = wb.abs().amax(dim=-2, keepdim=True) * (1 / 7)
        q = torch.round(wb / scale.clamp(min=1e-12)).clamp(-8, 7).to(
            torch.int8).reshape(w.shape)
        packed = (_pack_pairs(q[:, 0::2], q[:, 1::2]) if transposed
                  else _pack_pairs(q[0::2], q[1::2]))
        return packed.contiguous(), scale.contiguous()

    return _map_leading(one, kernel)


def quantize_tree(params: Any, skip: Sequence[str] = SKIP_MODULES,
                  bits: int = 8, block: int = 64,
                  int4_scheme: str = "half", int4_groups: int = 8) -> Any:
    """Replace eligible linear kernels (>= 2D, >= 4096 elements, not under
    a `skip` module) in place: bits=8 -> {"kernel": int8, "scale": f32},
    bits=4 -> {"kernel": packed int8, "scale4h": f32} (int4_scheme
    "half", `int4_groups` scale groups) or {"kernel": packed int8,
    "scale4": f32} (int4_scheme "block", one scale per `block` rows).
    Already quantized nodes are left alone. Mutates and returns
    `params`."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if int4_scheme not in ("half", "block"):
        raise ValueError(f"unknown int4_scheme {int4_scheme!r}")

    def rec(node, path):
        if isinstance(node, dict):
            if any(s in node for s in ("scale", "scale4", "scale4h")):
                return node
            if "kernel" in node and not any(s in path for s in skip):
                k = node["kernel"]
                if (isinstance(k, torch.Tensor) and k.dim() >= 2
                        and k.numel() >= 1 << 12):
                    transposed = (path[-1] if path else "") in \
                        TRANSPOSED_KERNELS
                    node["kernel"] = None
                    if bits == 4 and int4_scheme == "half":
                        q, s = _quantize_kernel4h(k, transposed, int4_groups)
                        node["kernel"], node["scale4h"] = q, s
                    elif bits == 4:
                        q, s = _quantize_kernel4(k, transposed, block)
                        node["kernel"], node["scale4"] = q, s
                    else:
                        out_axis = k.dim() - 2 if transposed else k.dim() - 1
                        q, s = _quantize_kernel(k, out_axis)
                        node["kernel"], node["scale"] = q, s
                    del k
                    for kk, vv in node.items():
                        if kk not in ("kernel", "scale", "scale4",
                                      "scale4h"):
                            node[kk] = rec(vv, path + (kk,))
                    return node
            for k2, v in node.items():
                node[k2] = rec(v, path + (k2,))
            return node
        if isinstance(node, list):
            return [rec(v, path) for v in node]
        return node

    return rec(params, ())


def dequantize_matmul(x: torch.Tensor, p: dict,
                      transposed: bool) -> torch.Tensor:
    """x @ (int8 kernel * scale), dequantized in x.dtype; transposed
    [.., out, in] kernels carry scale [.., out, 1]."""
    w = p["kernel"].to(x.dtype) * p["scale"].to(x.dtype)
    if transposed:
        return torch.einsum("...i,oi->...o", x, w)
    return x @ w


def dequantize_tree(params: Any, dtype=torch.bfloat16) -> Any:
    """Inverse of quantize_tree: every quantized kernel materialized back
    to `dtype` (train/lora.dequant_kernel) and its scale leaf dropped, so
    a quantized tree can be merged or exported. Mutates the tree."""
    from medplib_tpu_torch.train.lora import dequant_kernel

    def rec(node):
        if isinstance(node, dict):
            if any(s in node for s in ("scale", "scale4", "scale4h")):
                node["kernel"] = dequant_kernel(node, dtype)
                for s in ("scale", "scale4", "scale4h"):
                    node.pop(s, None)
            for v in node.values():
                rec(v)
        elif isinstance(node, list):
            for v in node:
                rec(v)

    rec(params)
    return params


def pad_moe_experts_for_gmm(experts: Any, align: int = 1024) -> Any:
    """Zero-pad the expert FFN dim M up to `align` (gate/up [.., H, M] ->
    [.., H, M'], down [.., M, H] -> [.., M', H]). Exact: padded gate/up
    channels are zero, silu(0)*0 = 0 meets zero down rows. Runs on the
    float tree, before quantization. Mutates and returns `experts`."""
    m = experts["gate_proj"]["kernel"].shape[-1]
    mp = -m % align
    if mp == 0:
        return experts
    for n in ("gate_proj", "up_proj", "down_proj"):
        node = experts[n]
        assert not any(s in node for s in ("scale", "scale4", "scale4h")), \
            "pad_moe_experts_for_gmm must run before quantization"
        k = node["kernel"]
        # F.pad counts from the last axis: (last_lo, last_hi, prev_lo, ...)
        pads = (0, mp) if n != "down_proj" else (0, 0, 0, mp)
        node["kernel"] = torch.nn.functional.pad(k, pads)
    return experts


def pad_dense_mlp_for_gmm(mlp: Any, align: int = 1024) -> Any:
    """The dense SwiGLU MLP's M zero-padded to a multiple of `align`
    (gate/up [L, H, M] -> [L, H, M'], down [L, M, H] -> [L, M', H]);
    exact, as pad_moe_experts_for_gmm. It may run after int8
    quantization: gate / up's per-channel scale pads with the out axis
    (zero scales), down's scale [L, 1, H] stays. int4 layouts must be
    padded before quantization. Mutates and returns `mlp`."""
    m = mlp["gate_proj"]["kernel"].shape[-1]
    mp = -m % align
    if mp == 0:
        return mlp
    for n in ("gate_proj", "up_proj", "down_proj"):
        node = mlp[n]
        assert not any(s in node for s in ("scale4", "scale4h")), \
            "int4 layouts must be padded before quantization"
        pads = (0, mp) if n != "down_proj" else (0, 0, 0, mp)
        node["kernel"] = torch.nn.functional.pad(node["kernel"], pads)
        if "scale" in node and n != "down_proj":
            node["scale"] = torch.nn.functional.pad(node["scale"], (0, mp))
    return mlp


def quantize_flagship_moe(params: Any, expert_bits: int = 4,
                          attn_bits: int = 8) -> Any:
    """The flagship's mixed precision: experts padded to M % 1024 == 0 and
    quantized int4h with per-half scales (groups=2), everything else
    eligible int8 (routers, norms, embeddings, towers stay float)."""
    moe = params["llm"]["layers"].get("moe")
    if moe is not None:
        moe["experts"] = pad_moe_experts_for_gmm(moe["experts"])
    if moe is not None and expert_bits != attn_bits:
        moe["experts"] = quantize_tree(moe["experts"], skip=(),
                                       bits=expert_bits, int4_groups=2)
    return quantize_tree(params, bits=attn_bits)


# ---------------------------------------------------------------------------
# int4 interleaved pairs: unpack, dequant, grouped matmuls, expert
# contraction
# ---------------------------------------------------------------------------

def _unpack(p: torch.Tensor, low: bool, dtype) -> torch.Tensor:
    """One nibble plane of a packed int8 tensor, sign-extended. Shifts run
    in int16 so no int8 shift can overflow."""
    p16 = p.to(torch.int16)
    if low:
        return ((p16 << 12) >> 12).to(dtype)
    return (p16 >> 4).to(dtype)


def dequant_int4h(packed: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """Materializing dequant of the pairs layout. Normal: packed
    [.., K/2, N] + scale [.., G, 1, N] -> [.., K, N]; transposed: packed
    [.., N, K/2] + scale [.., G, N, 1] -> [.., N, K]."""
    transposed = scale.shape[-1] == 1
    axis = packed.dim() - 1 if transposed else packed.dim() - 2
    lo = _unpack(packed, True, torch.float32)
    hi = _unpack(packed, False, torch.float32)
    w = torch.stack([lo, hi], dim=axis + 1)
    w = w.reshape(packed.shape[:axis] + (2 * packed.shape[axis],)
                  + packed.shape[axis + 1:])
    g_n = scale.shape[-3]
    if transposed:
        *lead, o, k = w.shape
        wb = w.reshape(*lead, o, g_n, k // g_n)
        s = scale.movedim(-3, -2)                  # [.., O, G, 1]
        return (wb * s).reshape(w.shape).to(dtype)
    *lead, k, o = w.shape
    wb = w.reshape(*lead, g_n, k // g_n, o)
    return (wb * scale).reshape(w.shape).to(dtype)


def int4h_matmul(x: torch.Tensor, packed: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(packed [K/2, N] pairs, scale4h [G, 1, N]), in
    x.dtype one scale group at a time, as the JAX package's XLA
    composition: y_g = (x_even_g @ lo_g + x_odd_g @ hi_g) * s_g, y = sum_g.
    Compiled with jax.jit, that program rounds each product, the pair sum,
    the scaled group and every group sum to x.dtype; so does this."""
    g_n = scale.shape[-3]
    gs2 = packed.shape[-2] // g_n              # packed rows per group
    xe, xo = x[..., 0::2], x[..., 1::2]
    y = None
    for g in range(g_n):
        pg = packed[g * gs2:(g + 1) * gs2]
        yg = (xe[..., g * gs2:(g + 1) * gs2] @ _unpack(pg, True, x.dtype)
              + xo[..., g * gs2:(g + 1) * gs2] @ _unpack(pg, False, x.dtype))
        yg = yg * scale[g, 0].to(x.dtype)
        y = yg if y is None else y + yg
    return y


def int4h_matmul_t(x: torch.Tensor, packed: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(packed [N, K/2] pairs, scale4h [G, N, 1]).T,
    group by group in x.dtype as int4h_matmul."""
    g_n = scale.shape[-3]
    gs2 = packed.shape[-1] // g_n
    xe, xo = x[..., 0::2], x[..., 1::2]
    y = None
    for g in range(g_n):
        pg = packed[:, g * gs2:(g + 1) * gs2]
        yg = (xe[..., g * gs2:(g + 1) * gs2] @ _unpack(pg, True, x.dtype).t()
              + xo[..., g * gs2:(g + 1) * gs2]
              @ _unpack(pg, False, x.dtype).t())
        yg = yg * scale[g, :, 0].to(x.dtype)
        y = yg if y is None else y + yg
    return y


def int4h_expert_einsum(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """einsum('ech,ehm->ecm') over int4h experts, in x.dtype: the lo / hi
    nibble planes pair with the even / odd columns of x, one pair of
    batched products per scale group. x [E, C, K]; packed [E, K/2, M];
    scale [E, G, 1, M]."""
    g_n = scale.shape[-3]
    gs2 = packed.shape[-2] // g_n
    xe, xo = x[..., 0::2], x[..., 1::2]
    y = None
    for g in range(g_n):
        pg = packed[:, g * gs2:(g + 1) * gs2]
        xeg = xe[..., g * gs2:(g + 1) * gs2]
        xog = xo[..., g * gs2:(g + 1) * gs2]
        yg = (torch.bmm(xeg, _unpack(pg, True, x.dtype))
              + torch.bmm(xog, _unpack(pg, False, x.dtype)))
        yg = yg * scale[:, g].to(x.dtype)
        y = yg if y is None else y + yg
    return y


# ---------------------------------------------------------------------------
# Dynamic activation quantization (W8A8 prefill)
# ---------------------------------------------------------------------------

_ACT_QUANT = threading.local()


def act_quant_enabled() -> bool:
    return getattr(_ACT_QUANT, "on", False)


@contextlib.contextmanager
def dynamic_act_quant(enabled: bool = True):
    """Run int8 linears with >= 512 rows as W8A8 (per-row dynamic
    activation quant) while inside this context. The JAX package reads the
    flag at trace time; here it is read at each call."""
    prev = act_quant_enabled()
    _ACT_QUANT.on = enabled
    try:
        yield
    finally:
        _ACT_QUANT.on = prev


@profiling.span("linear.w8a8")
def int8_dyn_matmul(x: torch.Tensor, w_q: torch.Tensor,
                    w_scale: torch.Tensor, transposed: bool) -> torch.Tensor:
    """y = (quant(x) @ w_q) * row scale * channel scale, with an exact s32
    product (torch._int_mm). w_q [K, N] or, transposed, [N, K]."""
    from medplib_tpu_torch.ops.cuda.gmm import quantize_rows
    lead = x.shape[:-1]
    x_q, a_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    w = w_q.t() if transposed else w_q
    y32 = torch._int_mm(x_q, w)
    y = y32.float() * a_scale * w_scale.reshape(1, -1).float()
    return y.to(x.dtype).reshape(lead + (y.shape[-1],))
