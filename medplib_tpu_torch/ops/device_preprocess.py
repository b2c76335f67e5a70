"""Device-side serving preprocess: resize + pad + normalize as two matmuls
per image (medplib_tpu/ops/device_preprocess.py), opt-in for the serving
worker (serve/worker.py device_preprocess=True).

PIL's antialiased BILINEAR resize is a separable triangle filter, so the
resized image is `Wy @ img @ Wx^T` for banded weight matrices built from
the image's true (h, w): output row i of the fixed target canvas maps to
resized row r = i - pad_top, whose source coordinate is (r + .5) *
(h / nh) - .5 with filter support max(1, h / nh); rows outside [0, nh)
get all-zero weights, which realizes the center pad. The host pads the
uint8 image into a fixed bucket canvas (`pick_bucket`) and ships (h, w)
beside it. SAM normalizes then zero-pads; CLIP pads with the
int-truncated pixel mean, then rescales and normalizes: the recipe of
data/preprocess.preprocess_sam / preprocess_clip, within ~1 grey level of
the host path (PIL evaluates the filter in fixed point). The JAX package
runs this in XLA, no Pallas kernel: here it is plain torch.matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from medplib_tpu_torch.data.preprocess import (CLIP_MEAN, CLIP_PAD_VALUE,
                                               CLIP_STD, SAM_PIXEL_MEAN,
                                               SAM_PIXEL_STD)


def _resize_weights(src: int, dst: torch.Tensor, n_src: int, n_dst: int,
                    device) -> torch.Tensor:
    """[n_dst, n_src] f32 triangle-filter weights resizing `src` valid
    pixels of a padded axis of length n_src onto the centered `dst` span
    of a fixed n_dst axis; rows outside the span are zero."""
    f32 = torch.float32
    src_t = torch.tensor(float(src), dtype=f32, device=device)
    scale = src_t / torch.clamp(dst, min=1.0)      # source px per dest px
    support = torch.clamp(scale, min=1.0)          # antialias on downscale
    top = torch.floor((n_dst - dst) / 2.0)         # center-pad offset
    i = torch.arange(n_dst, dtype=f32, device=device)[:, None]
    j = torch.arange(n_src, dtype=f32, device=device)[None, :]
    r = i - top
    center = (r + 0.5) * scale - 0.5
    w = torch.clamp(1.0 - torch.abs(j - center) / support, min=0.0)
    w = torch.where((r >= -0.5) & (r < dst) & (j < src_t), w,
                    torch.zeros((), dtype=f32, device=device))
    denom = w.sum(1, keepdim=True)
    return w / torch.clamp(denom, min=1e-8)


def _resize_canvas(img: torch.Tensor, h: int, w: int, target: int):
    """img [Hb, Wb, 3] f32 (valid pixels in the top-left [h, w] corner) ->
    ([target, target, 3] longest side resized and centered, [target,
    target] validity mask)."""
    hb, wb = img.shape[:2]
    dev = img.device
    scale = target / torch.tensor(float(max(h, w)), dtype=torch.float32,
                                  device=dev)
    nh = torch.floor(h * scale + 0.5)
    nw = torch.floor(w * scale + 0.5)
    wy = _resize_weights(h, nh, hb, target, dev)          # [T, Hb]
    wx = _resize_weights(w, nw, wb, target, dev)          # [T, Wb]
    rows = (wy @ img.reshape(hb, wb * 3)).reshape(target, wb, 3)
    out = (wx @ rows.permute(1, 0, 2).reshape(wb, target * 3)
           ).reshape(target, target, 3).permute(1, 0, 2)
    valid = (wy.sum(1) > 0.5)[:, None] & (wx.sum(1) > 0.5)[None, :]
    return out, valid


def dual_preprocess_device(img_u8: torch.Tensor, h: int, w: int,
                           sam_size: int = 256, clip_size: int = 336):
    """One uint8 canvas [Hb, Wb, 3] on the device (+ the true h, w) -> the
    model-ready pair (sam [sam_size, sam_size, 3] f32, clip [clip_size,
    clip_size, 3] f32)."""
    dev = img_u8.device
    img = img_u8.float()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    sam, sam_valid = _resize_canvas(img, h, w, sam_size)
    sam = (sam - t(SAM_PIXEL_MEAN)) / t(SAM_PIXEL_STD)
    sam = torch.where(sam_valid[..., None], sam, torch.zeros_like(sam))
    clip, clip_valid = _resize_canvas(img, h, w, clip_size)
    clip = torch.where(clip_valid[..., None], clip,
                       t(CLIP_PAD_VALUE.astype(np.float32)))
    clip = (clip / 255.0 - t(CLIP_MEAN)) / t(CLIP_STD)
    return sam, clip


def pick_bucket(h: int, w: int, buckets=(512, 1024, 2048)) -> int:
    for b in buckets:
        if h <= b and w <= b:
            return b
    return max(h, w)


def dual_preprocess(image_rgb: np.ndarray, sam_size: int = 256,
                    clip_size: int = 336, device="cuda"):
    """Host entry: pad the uint8 image into its size bucket (one copy),
    run the device program -> (sam, clip) tensors on `device` and the
    resize_hw of the host path."""
    h, w = image_rgb.shape[:2]
    b = pick_bucket(h, w)
    canvas = np.zeros((b, b, 3), np.uint8)
    canvas[:h, :w] = image_rgb
    sam, clip = dual_preprocess_device(
        torch.from_numpy(canvas).to(device), h, w, sam_size, clip_size)
    scale = sam_size / max(h, w)
    return sam, clip, (int(h * scale + 0.5), int(w * scale + 0.5))
