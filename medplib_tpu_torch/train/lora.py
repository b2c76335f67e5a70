"""LoRA adapters and the linears (medplib_tpu/train/lora.py): dequant, the
W8A8 switch, the grouped int4h products of 2D int4h nodes, LoRA injection,
the adapter branch with its dropout, the trainable mask, and `merge` (the
export path, and the route from a stage-3 checkpoint to a packed serving
tree).

A linear node is {"kernel", optional "scale" (int8) / "scale4h" (int4h),
optional "bias", optional "lora_a" [in, r] / "lora_b" [r, out]}; kernels
are [in, out], or [out, in] for the names in TRANSPOSED_KERNELS (linear_t).
With adapters the node computes y = x W + dropout(x) A B * scale.

LoRA dropout. The JAX package folds a trace-time call counter into the
step key, so its masks are fixed by the program. Here a mask is drawn from
a fresh torch.Generator seeded with (step seed, scope, call index within the
scope), where llama.forward opens one scope per decoder layer. A layer that
torch.utils.checkpoint recomputes during the backward therefore draws the
masks its forward drew, whichever thread autograd recomputes it on: the
scope carries its state explicitly (`dropout_state` / `dropout_scope`)
instead of relying on the RNG state that checkpoint restores.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence

import torch

from medplib_tpu_torch.ops.initializers import normal
from medplib_tpu_torch.utils import profiling

Params = Dict[str, Any]

# kernels stored [out, in] instead of [in, out]
TRANSPOSED_KERNELS = ("q_proj", "k_proj", "v_proj", "qkv_proj")
_QUANT_KEYS = ("scale", "scale4", "scale4h")

# ---------------------------------------------------------------------------
# LoRA dropout
# ---------------------------------------------------------------------------

_LORA_DROPOUT = threading.local()


def dropout_state() -> Optional[Dict[str, Any]]:
    """The active dropout state (None outside lora_dropout_ctx)."""
    return getattr(_LORA_DROPOUT, "state", None)


@contextlib.contextmanager
def _set_state(state):
    prev = dropout_state()
    _LORA_DROPOUT.state = state
    try:
        yield
    finally:
        _LORA_DROPOUT.state = prev


def lora_dropout_ctx(seed: int, rate: float):
    """Enable dropout (rate `rate`) on the adapter input of every LoRA
    linear called inside this context, with masks derived from `seed`."""
    return _set_state({"seed": int(seed), "rate": float(rate), "scope": -1,
                       "n": 0})


def dropout_scope(state: Optional[Dict[str, Any]], scope: int):
    """Run under a captured dropout `state` with the call counter reset for
    `scope` (a decoder layer index)."""
    return _set_state(None if state is None
                      else dict(state, scope=int(scope), n=0))


def mix_seed(*xs: int) -> int:
    """A 63-bit seed from a tuple of ints (FNV-style mixing)."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = ((h ^ (x & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) % (1 << 63)
    return h


def _lora_input(x: torch.Tensor, cols=None) -> torch.Tensor:
    """Dropout on the adapter input inside lora_dropout_ctx. Under a mesh
    x holds this rank's rows of the batch (dim 0) and, with cols = (i, m)
    (a row-parallel linear), block i of m of the features: the mask is
    drawn for the whole batch and feature width, as one process draws it,
    and this rank's block is kept."""
    from medplib_tpu_torch.parallel.mesh import ROWS, current_mesh
    st = dropout_state()
    if not st or st["rate"] <= 0.0:
        return x
    st["n"] += 1
    gen = torch.Generator(device=x.device)
    gen.manual_seed(mix_seed(st["seed"], st["scope"], st["n"]))
    keep = 1.0 - st["rate"]
    shape, r0, c0 = list(x.shape), 0, 0
    mesh = current_mesh()
    if mesh is not None:
        shape[0] *= mesh.size(ROWS)
        r0 = mesh.index(ROWS) * x.shape[0]
    if cols is not None:
        shape[-1] *= cols[1]
        c0 = cols[0] * x.shape[-1]
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    mask = mask.narrow(0, r0, x.shape[0]).narrow(
        x.dim() - 1, c0, x.shape[-1])
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# injection and the trainable mask
# ---------------------------------------------------------------------------

def _iter_linear_paths(tree: Params, prefix=()):
    if isinstance(tree, dict):
        if "kernel" in tree:
            yield prefix, tree
        for k, v in tree.items():
            if k != "kernel":
                yield from _iter_linear_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_linear_paths(v, prefix + (str(i),))


def _copy_containers(tree):
    if isinstance(tree, dict):
        return {k: _copy_containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_containers(v) for v in tree]
    return tree


def inject(gen: torch.Generator, params: Params,
           target_modules: Sequence[str], r: int,
           exclude: Sequence[str] = ("clip", "sam", "mask_encoder",
                                     "mm_token_compressor")) -> Params:
    """Add lora_a (normal / r) and lora_b (zeros) beside every kernel whose
    path ends in a target module name and is not under an excluded subtree.
    Returns a new tree of containers sharing the tensors of `params`.
    Adapters keep a float kernel's dtype and are bf16 beside a quantized
    one; packed int4 kernels hold half their reduction rows."""
    params = _copy_containers(params)
    n = 0
    for path, node in _iter_linear_paths(params):
        if any(e in path for e in exclude):
            continue
        if not path or path[-1] not in target_modules:
            continue
        kern = node["kernel"]
        *lead, din, dout = kern.shape
        transposed = path[-1] in TRANSPOSED_KERNELS
        if "scale4" in node or "scale4h" in node:
            if transposed:
                dout *= 2
            else:
                din *= 2
        if transposed:
            din, dout = dout, din
        adtype = kern.dtype if kern.is_floating_point() else torch.bfloat16
        node["lora_a"] = normal(gen, tuple(lead) + (din, r), adtype,
                                kern.device, 1.0 / r)
        node["lora_b"] = torch.zeros(tuple(lead) + (r, dout), dtype=adtype,
                                     device=kern.device)
        n += 1
    if n == 0:
        raise ValueError(f"no modules matched {target_modules}")
    return params


def trainable_mask(params: Params, sft_modules: Sequence[str]) -> Params:
    """Boolean tree: True for LoRA leaves and for leaves under an sft
    module, except that a quantized node (scale / scale4 / scale4h) is
    frozen apart from its adapters."""
    def rec(node, path, in_quant):
        if isinstance(node, dict):
            q = in_quant or any(s in node for s in _QUANT_KEYS)
            return {k: rec(v, path + (k,), q) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, path + (str(i),), in_quant)
                    for i, v in enumerate(node)]
        is_lora = bool(path) and path[-1] in ("lora_a", "lora_b")
        in_sft = any(m in path for m in sft_modules)
        return bool(is_lora or (in_sft and not in_quant))
    return rec(params, (), False)


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------

def dequant_kernel(p: Params, dtype) -> torch.Tensor:
    """The kernel as `dtype`: int8 nodes multiply by their per-channel
    scale in `dtype` (as the JAX package does), int4h nodes dequantize
    through dequant_int4h, float kernels pass through.

    int4 "block" nodes ({kernel nibble-packed int8, scale4 f32}, written
    by utils/quantize._quantize_kernel4) unpack both nibbles, sign-extended
    by shifts, interleave them back along the reduction axis (low nibble
    = even row) and scale each block, all in `dtype`; scale4 is
    [.., nb, 1, out] for [in, out] kernels and [.., out, nb, 1] for the
    transposed ones, told apart by its last axis being 1."""
    kern = p["kernel"]
    if "scale4h" in p:
        from medplib_tpu_torch.utils.quantize import dequant_int4h
        return dequant_int4h(kern, p["scale4h"], dtype)
    if "scale4" in p:
        from medplib_tpu_torch.utils.quantize import _unpack
        s = p["scale4"]
        transposed = s.shape[-1] == 1
        axis = kern.dim() - 1 if transposed else kern.dim() - 2
        w = torch.stack([_unpack(kern, True, dtype),
                         _unpack(kern, False, dtype)], dim=axis + 1)
        full = kern.shape[:axis] + (2 * kern.shape[axis],) \
            + kern.shape[axis + 1:]
        w, s = w.reshape(full), s.to(dtype)
        if transposed:
            nb = s.shape[-2]
            w = w.reshape(w.shape[:-1] + (nb, w.shape[-1] // nb)) * s
        else:
            nb = s.shape[-3]
            w = w.reshape(w.shape[:-2] + (nb, w.shape[-2] // nb,
                                          w.shape[-1])) * s
        return w.reshape(full)
    if kern.dtype == torch.int8:
        return kern.to(dtype) * p["scale"].to(dtype)
    return kern


def _use_w8a8(p: Params, x: torch.Tensor) -> bool:
    """W8A8 engages under dynamic_act_quant() for 2D int8 nodes without
    adapters when the call has >= 512 rows (prefill); decode stays
    weight-only. Under a mesh the rows are those of the global batch (the
    rank's times the row shards), so every rank switches as one process
    does."""
    if "scale" not in p or p["kernel"].dtype != torch.int8 \
            or p["kernel"].dim() != 2 or "lora_a" in p:
        return False
    from medplib_tpu_torch.utils.quantize import act_quant_enabled
    if not act_quant_enabled():
        return False
    from medplib_tpu_torch.parallel.mesh import row_shards
    rows = row_shards()
    for d in x.shape[:-1]:
        rows *= d
    return rows >= 512


def _lora_and_bias(p: Params, x: torch.Tensor, y: torch.Tensor,
                   scale: float) -> torch.Tensor:
    if "lora_a" in p:
        # bf16 adapters beside a quantized kernel meet f32 activations in
        # the small configs: promote as JAX does
        dt = torch.promote_types(x.dtype, p["lora_a"].dtype)
        xa = _lora_input(x).to(dt) @ p["lora_a"].to(dt)
        y = y + (xa @ p["lora_b"].to(dt)) * scale
    if "bias" in p:
        y = y + p["bias"]
    return y


def linear(p: Params, x: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """x @ kernel (+ LoRA branch, `scale` = alpha / r) (+ bias). A 2D int4h
    node takes the grouped products of utils/quantize.int4h_matmul; a
    stacked one dequantizes."""
    if _use_w8a8(p, x):
        from medplib_tpu_torch.utils.quantize import int8_dyn_matmul
        y = int8_dyn_matmul(x, p["kernel"], p["scale"], transposed=False)
    elif "scale4h" in p and p["kernel"].dim() == 2:
        from medplib_tpu_torch.utils.quantize import int4h_matmul
        y = int4h_matmul(x, p["kernel"], p["scale4h"])
    elif p["kernel"].dtype == torch.int8:     # int8, int4 block, int4h
        with profiling.span("linear.dequant"):
            y = x @ dequant_kernel(p, x.dtype)
    else:
        y = x @ p["kernel"]
    return _lora_and_bias(p, x, y, scale)


def linear_t(p: Params, x: torch.Tensor, scale: float = 2.0) -> torch.Tensor:
    """Linear with a transposed [out, in] kernel (q/k/v storage); adapters
    keep their [in, r] / [r, out] shapes."""
    if _use_w8a8(p, x):
        from medplib_tpu_torch.utils.quantize import int8_dyn_matmul
        y = int8_dyn_matmul(x, p["kernel"], p["scale"], transposed=True)
    elif "scale4h" in p and p["kernel"].dim() == 2:
        from medplib_tpu_torch.utils.quantize import int4h_matmul_t
        y = int4h_matmul_t(x, p["kernel"], p["scale4h"])
    elif p["kernel"].dtype == torch.int8:     # int8, int4 block, int4h
        with profiling.span("linear.dequant"):
            y = x @ dequant_kernel(p, x.dtype).t()
    else:
        y = x @ p["kernel"].t()
    return _lora_and_bias(p, x, y, scale)


def merge(params: Params, scale: float = 2.0) -> Params:
    """Fold each LoRA delta (lora_a @ lora_b * scale, transposed for the
    [out, in] kernels, cast to the kernel's dtype) into its kernel and drop
    the adapter leaves. Returns a new tree of containers; quantized nodes
    raise (dequantize first, or merge before quantizing)."""
    def rec(node, name=""):
        if isinstance(node, dict):
            if "kernel" in node and "lora_a" in node:
                if any(s in node for s in _QUANT_KEYS):
                    raise ValueError(
                        "cannot merge LoRA into a QUANTIZED kernel "
                        f"({name}): dequantize first (QLoRA export path: "
                        "keep adapters separate or merge pre-quantization)")
                delta = torch.einsum("...ir,...ro->...io", node["lora_a"],
                                     node["lora_b"]) * scale
                if name in TRANSPOSED_KERNELS:
                    delta = delta.transpose(-1, -2)
                out = {"kernel": node["kernel"]
                       + delta.to(node["kernel"].dtype)}
                for k, v in node.items():
                    if k not in ("kernel", "lora_a", "lora_b"):
                        out[k] = rec(v, k)
                return out
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [rec(v, name) for v in node]
        return node
    return rec(params)
