"""Multimodal projector, ICL extensions and region pooling
(medplib_tpu/models/projector.py):

- the projector "linear" / "mlpNx_gelu", through train/lora.linear because
  the flagship quantizes it to int8 (W8A8 at >= 512 rows under
  dynamic_act_quant);
- the token compressor (576 -> 256): adaptive average pooling over the
  token axis as an [out, in] matrix, LayerNorm, a linear;
- the mask encoder: four stride-2 3x3 convolutions with an exact GELU
  after each, pooled to a fixed token count, a linear, LayerNorm;
- the region adapter and the closed-form region pooling: bilinear
  sampling at every mask cell is a fixed [HW, HW] operator A, so the
  masked mean of the samples is (mask @ A / nnz) @ features.

The pooling and sampling matrices are cast to the features' dtype before
use, as in JAX (in bf16 that rounds 1 / (end - start)).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import ProjectorConfig
from medplib_tpu_torch.ops.initializers import dense_init, normal
from medplib_tpu_torch.ops.norms import layer_norm
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


def _init_ln(dim, dtype, device):
    return {"weight": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# token compressor
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic matrix with torch AdaptiveAvgPool1d's
    bins: bin i = [floor(i * n / o), ceil((i + 1) * n / o))."""
    mat = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-((i + 1) * n_in) // n_out)
        mat[i, start:end] = 1.0 / (end - start)
    return mat


def _pool(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(_adaptive_pool_matrix(n_in, n_out)).to(
        device=like.device, dtype=like.dtype)


def init_token_compressor(gen: torch.Generator, hidden: int,
                          dtype=torch.float32, device="cuda") -> Params:
    return {"norm": _init_ln(hidden, dtype, device),
            "proj": _init_linear(gen, hidden, hidden, dtype, device)}


def apply_token_compressor(p: Params, x: torch.Tensor,
                           num_tokens: int) -> torch.Tensor:
    """x [B, T, H] -> [B, num_tokens, H]."""
    x = torch.einsum("ot,bth->boh", _pool(x.shape[1], num_tokens, x), x)
    x = layer_norm(x, p["norm"]["weight"], p["norm"]["bias"])
    return x @ p["proj"]["kernel"] + p["proj"]["bias"]


# ---------------------------------------------------------------------------
# mask encoder
# ---------------------------------------------------------------------------

_MASK_ENC_CHANNELS = (64, 128, 256, 256)


def init_mask_encoder(gen: torch.Generator, hidden: int, dtype=torch.float32,
                      device="cuda") -> Params:
    convs, cin = [], 1
    for cout in _MASK_ENC_CHANNELS:            # HWIO, as the JAX tree
        convs.append({"kernel": normal(gen, (3, 3, cin, cout), dtype, device,
                                       (9 * cin) ** -0.5),
                      "bias": torch.zeros((cout,), dtype=dtype,
                                          device=device)})
        cin = cout
    return {"convs": convs,
            "proj": _init_linear(gen, 256, hidden, dtype, device),
            "norm": _init_ln(hidden, dtype, device)}


def apply_mask_encoder(p: Params, masks: torch.Tensor,
                       num_tokens: int) -> torch.Tensor:
    """masks [B, H, W] (binary float) -> [B, num_tokens, hidden]: four
    stride-2 3x3 convolutions (1 -> 64 -> 128 -> 256 -> 256, exact GELU
    after each), spatial flatten in (h, w) order, adaptive average pool to
    num_tokens, proj 256 -> hidden, LayerNorm."""
    x = masks[:, None].to(p["convs"][0]["kernel"].dtype)      # NCHW
    for conv in p["convs"]:
        x = F.conv2d(x, conv["kernel"].permute(3, 2, 0, 1),
                     conv["bias"], stride=2, padding=1)
        x = F.gelu(x, approximate="none")
    b, c, h, w = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    x = torch.einsum("ot,btc->boc", _pool(h * w, num_tokens, x), x)
    x = x @ p["proj"]["kernel"] + p["proj"]["bias"]
    return layer_norm(x, p["norm"]["weight"], p["norm"]["bias"])


# ---------------------------------------------------------------------------
# region adapter + closed-form region pooling
# ---------------------------------------------------------------------------

def init_region_adapter(gen: torch.Generator, mm_hidden: int, hidden: int,
                        dtype=torch.float32, device="cuda") -> Params:
    return _init_linear(gen, mm_hidden, hidden, dtype, device)


def apply_region_adapter(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


@lru_cache(maxsize=8)
def _bilinear_sample_matrix(h: int, w: int) -> np.ndarray:
    """[H*W, H*W] matrix A whose row p holds the bilinear weights of
    sampling the grid at cell p's coordinates as the reference does:
    grid_sample(align_corners=True) at normalized (y / H, x / W), i.e. at
    pixel position y * (H - 1) / H, not at the cell itself."""
    a = np.zeros((h * w, h * w), np.float32)
    for y in range(h):
        for x in range(w):
            fy = y * (h - 1) / h
            fx = x * (w - 1) / w
            y0, x0 = int(np.floor(fy)), int(np.floor(fx))
            y1, x1 = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
            dy, dx = fy - y0, fx - x0
            p = y * w + x
            a[p, y0 * w + x0] += (1 - dy) * (1 - dx)
            a[p, y0 * w + x1] += (1 - dy) * dx
            a[p, y1 * w + x0] += dy * (1 - dx)
            a[p, y1 * w + x1] += dy * dx
    return a


def region_pool(feature_map: torch.Tensor, region_masks: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Masked mean of bilinear-resampled region features, for every mask
    of the batch at once. feature_map [B, H*W, C] (the adapter's output on
    the CLIP grid); region_masks [B, M, H, W] binary; valid [B, M] bool
    -> [B, M, C], zeros for invalid masks. Every nonzero cell is sampled:
    the reference's random cap at 512 points is a training-only estimator
    of this mean."""
    b, m, h, w = region_masks.shape
    dt = feature_map.dtype
    a = torch.from_numpy(_bilinear_sample_matrix(h, w)).to(
        device=feature_map.device, dtype=dt)
    mflat = region_masks.reshape(b, m, h * w).to(dt)
    weights = torch.einsum("bmp,pq->bmq", mflat, a)
    nnz = mflat.sum(-1, keepdim=True).clamp(min=1.0)
    pooled = torch.einsum("bmq,bqc->bmc", weights / nnz, feature_map)
    return pooled * valid[..., None].to(pooled.dtype)
