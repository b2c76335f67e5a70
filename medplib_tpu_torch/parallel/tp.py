"""Tensor parallelism over the mesh's `model` axis, from the JAX package's
`model`-axis rules (parallel/mesh.py RULES: heads, kv_heads, mlp and vocab
shard over `model`).

Under a mesh with M = model > 1 each rank holds (shard_params):

- q / k / v [.., out, in] and gate / up [.., in, out] split on their
  output columns: column-parallel, the rank computes its heads' q / k / v
  and its block of the SwiGLU intermediate from the whole input;
- o_proj and down_proj split on their input rows: row-parallel, the rank
  multiplies its block of the input and the partial products are summed
  over `model` (f32 partials; W8A8 int32 partials, exact, after the
  activation-quant scale is taken over the whole row by a max over
  `model`);
- embed_tokens split on the vocabulary: a masked lookup of the rank's
  ids, then a sum over `model`; lm_head split on the vocabulary: the
  rank's logits, all-gathered before the argmax, sampling or the loss.

A leaf that param_spec leaves whole beside a split kernel (its
per-channel scale, LoRA factors, bias) is narrowed here to the rank's
block. Packed kernels (qkv_proj, gateup_proj) stay whole (shard_spec):
each rank cuts its q, k, v (gate, up) blocks out of them. Each rank attends over its own heads and its KV
cache holds them alone (`local_cfg`). MoE experts are not split (the JAX
package does not tensor-parallelize them either): every model rank runs
the same MoE on the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from medplib_tpu_torch.parallel.mesh import AXIS_MODEL, current_mesh

Params = Dict[str, Any]


def model_axis() -> Optional[Tuple[Any, int, int]]:
    """(mesh, M, this rank's model index) under a mesh whose model axis is
    larger than 1, else None."""
    mesh = current_mesh()
    if mesh is None or mesh.size(AXIS_MODEL) == 1:
        return None
    return mesh, mesh.size(AXIS_MODEL), mesh.coords[AXIS_MODEL]


def local_cfg(cfg):
    """The LlamaConfig of one model rank: its heads, kv heads and MLP
    block (head_dim and hidden size unchanged)."""
    tp = model_axis()
    if tp is None:
        return cfg
    m = tp[1]
    for n in (cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size):
        if n % m:
            raise ValueError(f"{cfg} does not split over {m} model ranks")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                               num_kv_heads=cfg.num_kv_heads // m,
                               intermediate_size=cfg.intermediate_size // m)


def _block(t: torch.Tensor, dim: int, m: int, i: int) -> torch.Tensor:
    c = t.shape[dim] // m
    return t.narrow(dim, i * c, c)


def _col_node(p: Params, transposed: bool, m: int, i: int) -> Params:
    """Companions of a column-split kernel narrowed to the rank's output
    columns: scale [out, 1] / [1, out], scale4h [G, out, 1] / [G, 1, out],
    scale4 [out, nb, 1] / [nb, 1, out], lora_b [r, out], bias [out]."""
    out = dict(p)
    for k in ("scale", "scale4h"):
        if k in p:
            out[k] = _block(p[k], p[k].dim() - (2 if transposed else 1), m, i)
    if "scale4" in p:
        out["scale4"] = _block(p["scale4"], p["scale4"].dim()
                               - (3 if transposed else 1), m, i)
    if "lora_b" in p:
        out["lora_b"] = _block(p["lora_b"], p["lora_b"].dim() - 1, m, i)
    if "bias" in p:
        out["bias"] = _block(p["bias"], p["bias"].dim() - 1, m, i)
    return out


def column_linear(p: Params, x: torch.Tensor, transposed: bool = False
                  ) -> torch.Tensor:
    """x @ W on the rank's output columns (the LoRA linear of
    train/lora.py)."""
    from medplib_tpu_torch.train.lora import linear, linear_t
    fn = linear_t if transposed else linear
    tp = model_axis()
    if tp is None:
        return fn(p, x)
    _, m, i = tp
    return fn(_col_node(p, transposed, m, i), x)


def row_linear(p: Params, x: torch.Tensor, scale: float = 2.0
               ) -> torch.Tensor:
    """x @ W with x and W's input rows split over `model` (an [in, out]
    kernel): the rank's partial product, summed over `model`; then the
    LoRA branch (its x·A partials summed the same way) and the bias."""
    from medplib_tpu_torch.train import lora
    tp = model_axis()
    if tp is None:
        return lora.linear(p, x, scale)
    mesh, m, i = tp
    base = {k: v for k, v in p.items()
            if k not in ("lora_a", "lora_b", "bias")}
    for k in ("scale4h", "scale4"):      # groups / blocks along the input
        if k in base:
            base[k] = _block(base[k], base[k].dim() - 3, m, i)
    lead = x.shape[:-1]
    if lora._use_w8a8(p, x):
        # the reference's per-row scale is over the whole row: a max over
        # `model` first; the int32 partials then sum exactly
        xf = x.reshape(-1, x.shape[-1]).float()
        amax = mesh.all_reduce(xf.abs().amax(-1, keepdim=True), AXIS_MODEL,
                               op="max")
        s = amax.clamp(min=1e-12) * (1 / 127)
        xq = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
        y32 = mesh.all_reduce(torch._int_mm(xq, base["kernel"]), AXIS_MODEL)
        y = (y32.float() * s * base["scale"].reshape(1, -1).float()
             ).to(x.dtype).reshape(lead + (y32.shape[-1],))
    else:
        if "scale4h" in base and base["kernel"].dim() == 2:
            from medplib_tpu_torch.utils.quantize import int4h_matmul
            part = int4h_matmul(x, base["kernel"], base["scale4h"]).float()
        else:
            part = x.float() @ lora.dequant_kernel(base, x.dtype).float()
        y = mesh.all_reduce(part, AXIS_MODEL).to(x.dtype)
    if "lora_a" in p:
        dt = torch.promote_types(x.dtype, p["lora_a"].dtype)
        xin = lora._lora_input(x, cols=(i, m))
        xa = mesh.all_reduce(
            xin.to(dt) @ _block(p["lora_a"], p["lora_a"].dim() - 2, m,
                                i).to(dt), AXIS_MODEL)
        y = y + (xa @ p["lora_b"].to(dt)) * scale
    if "bias" in p:
        y = y + p["bias"]
    return y


def packed_local(p: Params, sizes: Sequence[int], transposed: bool
                 ) -> Params:
    """A whole packed node (qkv_proj [out, in] transposed, gateup_proj
    [in, out]) -> the node of the rank's block of each segment of the
    concatenated output axis (`sizes`: the whole segments' widths),
    concatenated: a copy of the rank's share, no collective."""
    tp = model_axis()
    if tp is None:
        return p
    _, m, i = tp

    def cut(t):
        dim = t.dim() - (2 if transposed else 1)
        offs, parts = 0, []
        for n in sizes:
            c = n // m
            parts.append(t.narrow(dim, offs + i * c, c))
            offs += n
        return torch.cat(parts, dim)

    return {k: cut(p[k]) for k in ("kernel", "scale", "scale4h") if k in p}


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup of ids (>= 0) in a vocabulary-split table: the
    rank's rows, zeros for the ids of other ranks, summed over `model`."""
    tp = model_axis()
    if tp is None:
        return table[ids]
    mesh, _, i = tp
    v = table.shape[0]
    local = ids - i * v
    hit = (local >= 0) & (local < v)
    rows = table[local.clamp(0, v - 1)]
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return mesh.all_reduce(rows, AXIS_MODEL)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The rank's vocabulary block of logits -> all of them."""
    tp = model_axis()
    if tp is None:
        return logits
    return tp[0].all_gather(logits, AXIS_MODEL, dim=logits.dim() - 1)
