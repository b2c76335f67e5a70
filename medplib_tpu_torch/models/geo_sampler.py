"""GeoRegionSampler: Ferret-style geometric region feature pooling
(medplib_tpu/models/geo_sampler.py).

Sample points from each region mask, bilinear-sample their CLIP features,
then two stages of (farthest-point subsample -> kNN grouping -> diff / agg
projections -> pooling), and flatten + dim projectors. Every mask of the
batch is one row of [B*M, ...] tensors: point sampling is a stable sort of
the nonzero cells, FPS a loop over its `npoint` steps on [B*M, N] distance
rows, kNN a dense pairwise distance and a stable sort.

Selections are exact, on any device. The distances take the reference's
order ((-2·q·p + q²) + p²) with every two-term sum a0·b0 + a1·b1 as the
JAX package computes it on the CPU, where XLA contracts it to
fma(a1, b1, a0·b0): `_dot2` emulates that fma exactly with float64 torch
ops (no matmul, whose FMA or tile order on the card would move a last
bit). Ties go to the lowest index, as lax.top_k and jnp.argmax break
them: selections sort unique int64 keys (the value's order-preserving
bits, then the index), so no sort's tie handling on any device matters,
and the argmax takes the lowest index of the maximum.

Features are promoted to float32 as JAX promotes bf16 features against
float32 coordinates; the projections then run in float32 on the kernels
widened to float32, as jnp's bf16 @ f32 does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from medplib_tpu_torch.ops.initializers import dense_init
from medplib_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def _linear(gen, din, dout, dtype, device):
    return {"kernel": dense_init(gen, din, dout, dtype, device),
            "bias": torch.zeros((dout,), dtype=dtype, device=device)}


def init_geo_sampler(gen: torch.Generator, input_dim: int, output_dim: int,
                     num_sub_point: Sequence[int] = (128, 32),
                     dtype=torch.float32, device="cuda") -> Params:
    d = input_dim
    stages = []
    for _ in num_sub_point:
        agg = _linear(gen, 2 * (d + 2), d, dtype, device)
        agg["norm"] = {"weight": torch.ones((d,), dtype=dtype, device=device),
                       "bias": torch.zeros((d,), dtype=dtype, device=device)}
        stages.append({"diff": _linear(gen, d + 2, d + 2, dtype, device),
                       "agg": agg})
    return {
        "stages": stages,
        "flatten_projector": _linear(gen, d * num_sub_point[-1], d, dtype,
                                     device),
        "dim_projector": _linear(gen, d, output_dim, dtype, device),
    }


def _argsort_rows(key32: torch.Tensor) -> torch.Tensor:
    """Ascending argsort of each row of an int32-ranged integer key, ties
    in index order, by sorting the unique keys key * N + index."""
    n = key32.shape[-1]
    idx = torch.arange(n, device=key32.device)
    return torch.sort(key32.long() * n + idx, dim=-1).indices


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose integer order is the floats' order (-0.0 is
    taken as +0.0)."""
    bits = (x + 0.0).view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def sample_mask_points(masks: torch.Tensor, num_points: int) -> torch.Tensor:
    """masks [N, H, W] binary -> [N, P, 2] normalized (y / H, x / W)
    coordinates of nonzero cells in row-major order (the JAX package's
    deterministic order, lax.top_k over -index; its random order under a
    `key` has no caller), repeated cyclically when a mask has fewer than P
    (rand_sample_repeat)."""
    n, h, w = masks.shape
    flat = masks.reshape(n, h * w) > 0
    count = flat.sum(-1)
    order = _argsort_rows((~flat).int())[:, :min(num_points, h * w)]
    take = torch.arange(num_points, device=masks.device)[None, :] \
        % count.clamp(min=1)[:, None]
    sel = torch.gather(order, 1, take.clamp(0, order.shape[1] - 1))
    # divide by a device tensor: CUDA turns a Python-number divisor into a
    # multiplication by its reciprocal, which moves last bits
    hw = torch.tensor([h, w], dtype=torch.float32, device=masks.device)
    ys = torch.div(sel, w, rounding_mode="floor").float() / hw[0]
    xs = (sel % w).float() / hw[1]
    return torch.stack([ys, xs], dim=-1)


def bilinear_point_features(feature_map: torch.Tensor,
                            coords_yx: torch.Tensor) -> torch.Tensor:
    """feature_map [N, H, W, C], coords [N, P, 2] (y, x) in [0, 1]
    -> [N, P, C] in float32; grid_sample(align_corners=True) on 2c - 1
    grids."""
    n, h, w, c = feature_map.shape
    fy = coords_yx[..., 0] * (h - 1)
    fx = coords_yx[..., 1] * (w - 1)
    y0 = torch.floor(fy).long().clamp(0, h - 1)
    x0 = torch.floor(fx).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    dy = (fy - y0)[..., None]
    dx = (fx - x0)[..., None]
    flat = feature_map.reshape(n, h * w, c)

    def at(y, x):
        idx = (y * w + x)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx).float()

    return (at(y0, x0) * (1 - dy) * (1 - dx) + at(y0, x1) * (1 - dy) * dx
            + at(y1, x0) * dy * (1 - dx) + at(y1, x1) * dy * dx)


def _dot2(a0, b0, a1, b1) -> torch.Tensor:
    """float32 fma(a1, b1, fl(a0 * b0)), exactly: a1·b1 is exact in
    float64, the float64 sum is rounded to odd (TwoSum's exact error
    decides), and rounding that to float32 is then correct."""
    x = a1.double() * b1.double()
    y = (a0 * b0).double()
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of each row's maximum, the lowest one on ties."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device).expand_as(x)
    hit = x == x.amax(dim=-1, keepdim=True)
    return torch.where(hit, idx, torch.full_like(idx, n)).amin(dim=-1)


def farthest_point_sample(points: torch.Tensor, npoint: int,
                          start_idx: int = 0) -> torch.Tensor:
    """points [N, P, 2] -> [N, npoint] indices (the reference starts from a
    random index; start_idx fixes it)."""
    n, p, _ = points.shape
    rows = torch.arange(n, device=points.device)
    centroids = torch.zeros((n, npoint), dtype=torch.long,
                            device=points.device)
    distance = torch.full((n, p), 1e10, dtype=torch.float32,
                          device=points.device)
    farthest = torch.full((n,), start_idx, dtype=torch.long,
                          device=points.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        d = points - points[rows, farthest][:, None, :]
        distance = torch.minimum(distance, _dot2(d[..., 0], d[..., 0],
                                                 d[..., 1], d[..., 1]))
        farthest = _first_argmax(distance)
    return centroids


def knn(points: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """points [N, P, 2], queries [N, S, 2] -> [N, S, k] nearest-neighbour
    indices. The squared distance is (-2·q·p + q²) + p², the reference's
    square_distance order: grid points tie massively, and the k-th
    neighbour depends on the exact float values."""
    q, p = queries[:, :, None, :], points[:, None, :, :]
    qp = _dot2(q[..., 0], p[..., 0], q[..., 1], p[..., 1])
    q2 = _dot2(queries[..., 0], queries[..., 0],
               queries[..., 1], queries[..., 1])
    p2 = _dot2(points[..., 0], points[..., 0], points[..., 1], points[..., 1])
    d = -2.0 * qp + q2[:, :, None]
    d = d + p2[:, None, :]
    return _argsort_rows(_ordered_bits(d))[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, P, C], idx [N, ...] -> [N, ..., C]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def _dense(p, x):
    return x @ p["kernel"].float() + p["bias"].float()


def apply_geo_sampler(params: Params, feature_map: torch.Tensor,
                      region_masks: torch.Tensor, valid: torch.Tensor,
                      num_init_point: int = 512,
                      num_sub_point: Sequence[int] = (128, 32),
                      num_neighbor: Sequence[int] = (24, 24),
                      pooler_mode: str = "max") -> torch.Tensor:
    """feature_map [B, H*W, C] (RAW CLIP features: the geo path pools
    before any adapter); region_masks [B, M, Hm, Wm]; valid [B, M]
    -> [B, M, out_dim] in float32, zeros for invalid masks."""
    b, m = region_masks.shape[:2]
    hw, c = feature_map.shape[1:]
    g = int(math.isqrt(hw))
    fmap = feature_map.reshape(b, 1, g, g, c).expand(b, m, g, g, c)
    fmap = fmap.reshape(b * m, g, g, c)
    pts = sample_mask_points(region_masks.reshape((b * m,)
                                                  + region_masks.shape[2:]),
                             num_init_point)
    fea = bilinear_point_features(fmap, pts)
    for sp, nsub, nnb in zip(params["stages"], num_sub_point, num_neighbor):
        fps_idx = farthest_point_sample(pts, nsub)
        new_pts, new_fea = _take(pts, fps_idx), _take(fea, fps_idx)
        nb = knn(pts, new_pts, nnb)                          # [N, nsub, k]
        local = torch.cat([_take(fea, nb), _take(pts, nb)], dim=-1)
        anchor = torch.cat([new_fea, new_pts], dim=-1)[:, :, None]
        diff = _dense(sp["diff"], local - anchor)
        gathered = torch.cat([diff, anchor.expand_as(diff)], dim=-1)
        # ConvReLULN1D: 1x1 conv (a linear) + ReLU + LayerNorm on channels
        gathered = torch.relu(_dense(sp["agg"], gathered))
        gathered = layer_norm(gathered, sp["agg"]["norm"]["weight"],
                              sp["agg"]["norm"]["bias"])
        fea = (gathered.amax(dim=2) if pooler_mode == "max"
               else gathered.mean(dim=2))
        pts = new_pts
    x = _dense(params["flatten_projector"], fea.reshape(b * m, -1))
    out = _dense(params["dim_projector"], x).reshape(b, m, -1)
    return out * valid[..., None].to(out.dtype)
