"""Whole-stack layer-indexed W8A8 linears for prefill, opt-in
(medplib_tpu/ops/stacked.py).

The quantized projection stacks ([L, out, in] q / k / v, [L, in, out]
o_proj and the dense MLP, int8 exactly as stored) go WHOLE through the
grouped matmul K3 in its W8A8 mode (ops/cuda/gmm.gmm) with the layer index
as every tile's group id: one activation-quant pass per input
(`quantize_rows_padded`, rows zero-padded to the tile), s8 x s8 products
with the (row x channel) rescale in the kernel's epilogue.

The JAX package measured both formulations as losses on the TPU and keeps
them as A/B knobs; so does the port: `models/llama.forward` engages them
only under `utils/quantize.dynamic_act_quant`, at prefill (S >= 1024),
with MEDPLIB_STACK_ATTN=1 (attention projections) or MEDPLIB_STACK_MLP=1
(the dense MLP of a dense model), both 0 by default. Stacks with live LoRA
adapters, other layouts and shapes the JAX kernel would pad stay on the
default path, and so does a tensor-parallel forward (its blocks are split
over the model axis).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]

_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP_PROJ = ("gate_proj", "up_proj", "down_proj")


def _gmm_shape_ok(n_out: int, k_in: int) -> bool:
    """The JAX kernel's pad-free shapes: a K block of at least 1024 that
    divides K (gmm.py:_pick_bk), and N a multiple of 512 (or <= 512 and a
    multiple of 128)."""
    best = next((128 * m for m in range(min(2048, k_in) // 128, 0, -1)
                 if k_in % (128 * m) == 0), k_in)
    if best < 1024:
        return False
    return n_out % 512 == 0 or (n_out <= 512 and n_out % 128 == 0)


def _int8_stack(node) -> bool:
    k = node.get("kernel") if isinstance(node, dict) else None
    return (k is not None and "scale" in node and "lora_a" not in node
            and k.dtype == torch.int8 and k.dim() == 3)


def stack_attn_for_w8a8(layers: Params, s_tokens: int) -> Optional[Params]:
    """Whole-stack view of the attention projection stacks, or None: every
    projection weight-only int8 without adapters, pad-free shapes,
    S >= 1024. q / k / v scales [L, out, 1] are swapped channel-last."""
    from medplib_tpu_torch.parallel.tp import model_axis
    if s_tokens < 1024 or model_axis() is not None:
        return None
    attn = layers.get("attn")
    if attn is None or not all(n in attn for n in _ATTN_PROJ):
        return None              # packed qkv_proj trees keep their path
    out = {}
    for n in _ATTN_PROJ:
        node = attn[n]
        if not _int8_stack(node):
            return None
        k = node["kernel"]
        trans = n != "o_proj"    # o_proj is stored [L, in, out]
        k_in = k.shape[-1] if trans else k.shape[-2]
        n_out = k.shape[-2] if trans else k.shape[-1]
        if not _gmm_shape_ok(n_out, k_in):
            return None
        sc = node["scale"].float()
        if trans:
            sc = sc.transpose(-1, -2)
        out[n] = {"kernel": k, "scale": sc.contiguous(), "transposed": trans}
    return out


def stack_mlp_for_w8a8(layers: Params, s_tokens: int) -> Optional[Params]:
    """Whole-stack view of the dense SwiGLU stacks, or None (the same
    contract; the FFN width must already be pad-free, e.g. after
    utils/quantize.pad_dense_mlp_for_gmm)."""
    from medplib_tpu_torch.parallel.tp import model_axis
    if s_tokens < 1024 or model_axis() is not None:
        return None
    mlp = layers.get("mlp")
    if not isinstance(mlp, dict) or not all(n in mlp for n in _MLP_PROJ):
        return None
    out = {}
    for n in _MLP_PROJ:
        node = mlp[n]
        if not _int8_stack(node):
            return None
        k = node["kernel"]
        if not _gmm_shape_ok(k.shape[-1], k.shape[-2]):
            return None
        out[n] = {"kernel": k, "scale": node["scale"].float(),
                  "transposed": False}
    return out


def quantize_rows_padded(x2d: torch.Tensor, block_m: int = 512):
    """Per-row int8 activation quant with rows zero-padded to block_m
    (padded rows get zero values and scales, so zero outputs).
    -> (x_q [Sp, K] int8, scales [Sp, 1] f32, rows)."""
    from medplib_tpu_torch.ops.cuda.gmm import quantize_rows
    rows = x2d.shape[0]
    pad = -rows % block_m
    xq, sc = quantize_rows(x2d)
    if pad:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, pad))
        sc = torch.nn.functional.pad(sc, (0, 0, 0, pad))
    return xq, sc, rows


def _tile_gid(sp: int, block_m: int, layer_idx: int, dev) -> torch.Tensor:
    return torch.full((sp // block_m,), int(layer_idx), dtype=torch.int32,
                      device=dev)


def stacked_w8a8_linear(node: Params, xq: torch.Tensor, xsc: torch.Tensor,
                        layer_idx: int, rows: int,
                        block_m: int = 512) -> torch.Tensor:
    """One projection: K3 W8A8 over the whole [L, ., .] stack with every
    tile addressed to `layer_idx`. xq / xsc from quantize_rows_padded.
    -> [rows, N] bf16."""
    from medplib_tpu_torch.ops.cuda.gmm import gmm
    y = gmm(xq, node["kernel"], _tile_gid(xq.shape[0], block_m, layer_idx,
                                          xq.device),
            node["scale"], a_scale=xsc, block_m=block_m, allow_pad=False,
            transposed=node["transposed"])
    return y[:rows]


def stacked_dense_mlp(stacks: Params, x: torch.Tensor, layer_idx: int,
                      block_m: int = 512) -> torch.Tensor:
    """Dense SwiGLU via whole-stack W8A8: one quant pass feeds gate and
    up, silu(g) * u is re-quantized per row, then down.
    x [B, T, H] -> [B, T, H] in x.dtype."""
    from medplib_tpu_torch.ops.cuda.gmm import quantize_rows
    from medplib_tpu_torch.ops.moe import _silu
    b, t, h = x.shape
    xq, xsc, rows = quantize_rows_padded(x.reshape(b * t, h), block_m)
    g = stacked_w8a8_linear(stacks["gate_proj"], xq, xsc, layer_idx,
                            xq.shape[0], block_m)
    u = stacked_w8a8_linear(stacks["up_proj"], xq, xsc, layer_idx,
                            xq.shape[0], block_m)
    # the compiled reference keeps silu(g) * u unrounded (f32) where it
    # feeds the activation quant, as in ops/moe._gmm_ffn
    aq, asc = quantize_rows(_silu(g).float() * u.float())
    y = stacked_w8a8_linear(stacks["down_proj"], aq, asc, layer_idx,
                            aq.shape[0], block_m)
    return y[:rows].reshape(b, t, h).to(x.dtype)
