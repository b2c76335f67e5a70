"""Multimodal projector "linear" / "mlpNx_gelu"
(medplib_tpu/models/projector.py:47-78). It goes through train/lora.linear
because the flagship quantizes it to int8 (W8A8 at >= 512 rows under
dynamic_act_quant). The ICL compressor, mask encoder and region pooling are
not ported yet; the region adapter's params are initialized so that the
tree matches the JAX one."""

from __future__ import annotations

import re
from typing import Any, Dict

import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import ProjectorConfig
from medplib_tpu_torch.ops.initializers import dense_init
from medplib_tpu_torch.train.lora import linear

Params = Dict[str, Any]


def _init_linear(gen, din, dout, dtype, device):
    return {"kernel": dense_init(gen, din, dout, dtype, device),
            "bias": torch.zeros((dout,), dtype=dtype, device=device)}


def init_projector(gen: torch.Generator, cfg: ProjectorConfig,
                   dtype=torch.float32, device="cuda") -> Params:
    m = re.match(r"^mlp(\d+)x_gelu$", cfg.projector_type)
    if cfg.projector_type == "linear":
        depth = 1
    elif m:
        depth = int(m.group(1))
    else:
        raise ValueError(f"unknown projector type {cfg.projector_type!r}")
    layers = [_init_linear(gen, cfg.mm_hidden_size, cfg.hidden_size, dtype,
                           device)]
    for _ in range(1, depth):
        layers.append(_init_linear(gen, cfg.hidden_size, cfg.hidden_size,
                                   dtype, device))
    return {"layers": layers}


def apply_projector(p: Params, x: torch.Tensor) -> torch.Tensor:
    for i, lin in enumerate(p["layers"]):
        if i > 0:
            x = F.gelu(x, approximate="none")
        x = linear(lin, x)
    return x


def init_region_adapter(gen: torch.Generator, mm_hidden: int, hidden: int,
                        dtype=torch.float32, device="cuda") -> Params:
    return _init_linear(gen, mm_hidden, hidden, dtype, device)
