"""Host-side image preprocessing (medplib_tpu/data/preprocess.py) in numpy,
with the JAX package's dual SAM / CLIP recipe:

SAM path:  resize the longest side to 256 -> normalize (ImageNet * 255
           stats) -> center-pad to 256 x 256 with zeros (pad AFTER
           normalize)
CLIP path: resize the longest side to 336 -> center-pad to 336 x 336 with
           the int-truncated CLIP pixel mean (pad BEFORE normalize) ->
           rescale 1/255 -> CLIP mean / std normalize
Region:    resize the mask's longest side to 336 -> center-pad 336 -> 1/14
           nearest downsample to 24 x 24 -> training-time random
           sub-component augmentation

Two resamplers, both the separable triangle filter of PIL's BILINEAR:

- the float resampler of the C++ library (the port's copy of it,
  medplib_tpu_torch/native, built at first use): per-axis weights computed
  in double and stored as float32, float32 sums in tap order, no uint8
  rounding. preprocess_sam / preprocess_clip run the library on uint8 RGB
  images when it loads (`_native`, USE_NATIVE as in the JAX package), else
  `_resize_float`, the same computation in numpy.
- `resize_longest_side` is PIL's `Image.resize(..., BILINEAR)`, which the
  JAX package calls for masks and as its fallback: on uint8 images PIL's
  fixed-point arithmetic (22-bit weights, a uint8 rounding after each
  pass), on float32 masks PIL's mode "F" arithmetic (double sums, a
  float32 rounding after each pass). Integer sums make the uint8 results
  exact, so region grids equal the JAX package's bit for bit.

Each pass gathers the source at one tap offset at a time: a filter has a
few taps, so a pass is a few vectorized multiply-adds over the output.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np

SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# the reference pads with the int-truncated mean
CLIP_PAD_VALUE = np.clip((CLIP_MEAN * 255).astype(np.int32), 0, 255)

_PRECISION_BITS = 22          # PIL's 8-bit resampler: 32 - 8 - 2


def _longest_side_hw(h: int, w: int, target: int) -> Tuple[int, int]:
    scale = target / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _taps(in_size: int, out_size: int, reciprocal: bool):
    """Triangle-filter taps of one axis -> (first source index [out]
    int64, weights [out, ksize] float64, zero past each row's count).
    reciprocal: PIL's x * (1 / filterscale); else the C++ library's
    x / filterscale."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale          # the triangle's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    lo = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    hi = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                    in_size)
    k = np.arange(ksize, dtype=np.int64)[None, :]
    x = (lo[:, None] + k) - center[:, None] + 0.5
    x = x * (1.0 / filterscale) if reciprocal else x / filterscale
    w = np.where(np.abs(x) < 1.0, 1.0 - np.abs(x), 0.0)
    w = np.where(k < (hi - lo)[:, None], w, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):         # the C loops' order of double sums
        total = total + w[:, j]
    w = np.where(total[:, None] > 0, w / np.where(total > 0, total,
                                                  1.0)[:, None], 0.0)
    return lo, w


def _gather(src: np.ndarray, axis: int, lo: np.ndarray, j: int):
    idx = np.minimum(lo + j, src.shape[axis] - 1)
    return np.take(src, idx, axis=axis)


def _pass_float32(src: np.ndarray, axis: int, lo, w32) -> np.ndarray:
    """float32 sums over the taps in order, from 0 (the C++ library)."""
    shape = [1] * src.ndim
    shape[axis] = -1
    acc = np.zeros(src.shape[:axis] + (len(lo),) + src.shape[axis + 1:],
                   np.float32)
    for j in range(w32.shape[1]):
        acc += _gather(src, axis, lo, j) * w32[:, j].reshape(shape)
    return acc


def _resize_float(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """uint8 [H, W, C] -> float32 [oh, ow, C], the JAX package's default
    resampler: horizontal pass, then vertical."""
    h, w = image.shape[:2]
    if oh == 0 or ow == 0:
        return np.zeros((oh, ow) + image.shape[2:], np.float32)
    src = image.astype(np.float32)
    lo_x, wx = _taps(w, ow, reciprocal=False)
    lo_y, wy = _taps(h, oh, reciprocal=False)
    tmp = _pass_float32(src, 1, lo_x, wx.astype(np.float32))
    return _pass_float32(tmp, 0, lo_y, wy.astype(np.float32))


def _pass_pil(src: np.ndarray, axis: int, lo, w) -> np.ndarray:
    """One pass of PIL's resampler: uint8 in fixed point (sums of
    uint8 x 22-bit weights plus a half, shifted and clipped), float32 in
    double sums rounded to float32."""
    shape = [1] * src.ndim
    shape[axis] = -1
    if src.dtype == np.uint8:
        kk = np.trunc(0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
        acc = np.full(src.shape[:axis] + (len(lo),) + src.shape[axis + 1:],
                      1 << (_PRECISION_BITS - 1), np.int64)
        for j in range(kk.shape[1]):
            acc += _gather(src, axis, lo, j).astype(np.int64) * \
                kk[:, j].reshape(shape)
        return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    acc = np.zeros(src.shape[:axis] + (len(lo),) + src.shape[axis + 1:],
                   np.float64)
    for j in range(w.shape[1]):
        acc = acc + _gather(src, axis, lo, j).astype(np.float64) * \
            w[:, j].reshape(shape)
    return acc.astype(np.float32)


def pil_bilinear_resize(image: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """`np.asarray(Image.fromarray(image).resize((ow, oh), BILINEAR))` for
    uint8 [H, W] / [H, W, 3] (modes L, RGB) and float32 [H, W] (mode F):
    a horizontal pass where the width changes, then a vertical one where
    the height does."""
    if image.dtype == np.uint8 and (image.ndim == 2 or (
            image.ndim == 3 and image.shape[2] == 3)):
        pass
    elif image.dtype == np.float32 and image.ndim == 2:
        pass
    else:
        raise TypeError(f"no PIL bilinear mode for {image.dtype} "
                        f"{image.shape}")
    h, w = image.shape[:2]
    out = image
    if ow != w:
        out = _pass_pil(out, 1, *_taps(w, ow, reciprocal=True))
    if oh != h:
        out = _pass_pil(out, 0, *_taps(h, oh, reciprocal=True))
    return out.copy() if out is image else out


def resize_longest_side(image: np.ndarray, target: int) -> np.ndarray:
    """[H, W, C] or [H, W] -> longest side == target, PIL bilinear."""
    h, w = image.shape[:2]
    return pil_bilinear_resize(image, *_longest_side_hw(h, w, target))


def center_pad(x: np.ndarray, size: int, pad_value) -> np.ndarray:
    """Pad [H, W, C]/[H, W] to [size, size, ...] with the reference's
    top/left = pad//2 split (pad_tensor_channelwise)."""
    h, w = x.shape[:2]
    pad_h, pad_w = size - h, size - w
    top, left = pad_h // 2, pad_w // 2
    if x.ndim == 3:
        out = np.empty((size, size, x.shape[2]), x.dtype)
        out[...] = pad_value
        out[top:top + h, left:left + w] = x
    else:
        out = np.full((size, size), pad_value, x.dtype)
        out[top:top + h, left:left + w] = x
    return out


def _is_rgb_u8(image: np.ndarray) -> bool:
    return image.ndim == 3 and image.dtype == np.uint8


def _native():
    """The native library's wrappers (medplib_tpu_torch/native): lazy,
    cached, None where it does not build or load."""
    global _NATIVE
    if _NATIVE is _UNSET:
        from medplib_tpu_torch import native
        _NATIVE = native if native.available() else None
    return _NATIVE


_UNSET = object()
_NATIVE = _UNSET
USE_NATIVE = True


def preprocess_sam(image_rgb: np.ndarray, size: int = 256):
    """-> (pixels [size, size, 3] f32 normalized, resize_hw before pad)."""
    nat = _native() if USE_NATIVE else None
    if nat is not None and _is_rgb_u8(image_rgb):
        return nat.sam_preprocess(image_rgb, size, SAM_PIXEL_MEAN,
                                  SAM_PIXEL_STD)
    if _is_rgb_u8(image_rgb):
        resize_hw = _longest_side_hw(*image_rgb.shape[:2], size)
        resized = _resize_float(image_rgb, *resize_hw)
    else:
        resized = resize_longest_side(image_rgb, size)
        resize_hw = resized.shape[:2]
    x = (resized.astype(np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
    return center_pad(x, size, 0.0), resize_hw


def preprocess_clip(image_rgb: np.ndarray, size: int = 336) -> np.ndarray:
    """-> [size, size, 3] f32, CLIP-normalized."""
    nat = _native() if USE_NATIVE else None
    if nat is not None and _is_rgb_u8(image_rgb):
        return nat.clip_preprocess(image_rgb, size, CLIP_MEAN, CLIP_STD)
    if _is_rgb_u8(image_rgb):
        resized = _resize_float(
            image_rgb, *_longest_side_hw(*image_rgb.shape[:2], size))
    else:
        resized = resize_longest_side(image_rgb, size)
    padded = center_pad(resized.astype(np.float32), size,
                        CLIP_PAD_VALUE.astype(np.float32))
    return (padded / 255.0 - CLIP_MEAN) / CLIP_STD


def preprocess_region_mask(mask: np.ndarray, clip_size: int = 336,
                           patch: int = 14) -> np.ndarray:
    """Binary region mask at original res -> [clip_size/patch]^2 grid."""
    resized = resize_longest_side(mask.astype(np.uint8), clip_size)
    padded = center_pad(resized, clip_size, 0)
    grid = clip_size // patch
    # 1/14 nearest-neighbor downsample (cv2.resize INTER_NEAREST fx=1/14)
    idx = (np.arange(grid) * patch).astype(np.int64)
    return padded[np.ix_(idx, idx)].astype(np.float32)


def sub_component_augment(mask: np.ndarray, min_area: float = 0.2,
                          max_area: float = 1.0, min_thresh: int = 10,
                          rng: Optional[random.Random] = None
                          ) -> Tuple[np.ndarray, bool]:
    """Random connected-sub-component augmentation: pick the largest
    connected component, grow a random connected subregion covering a
    `min_area..max_area` fraction of it. Returns (mask', is_valid). Labels
    come from cv2 where it is installed (8-connected), else from
    _connected_components (4-connected), as in the JAX package."""
    rng = rng or random
    if mask.sum() <= 0:
        return np.ones_like(mask), False
    try:
        import cv2
        num, labels = cv2.connectedComponents(mask.astype(np.uint8))
    except ImportError:
        labels = _connected_components(mask.astype(np.uint8))
        num = labels.max() + 1
    if num <= 1:
        return mask, True
    areas = [(labels == v).sum() for v in range(1, num)]
    component = (labels == (1 + int(np.argmax(areas)))).astype(np.uint8)
    comp_area = int(component.sum())
    if comp_area < min_thresh:
        return component.astype(mask.dtype), True

    # bounded resample: comp_area == min_thresh can never satisfy the
    # threshold (uniform() < 1.0 -> int() rounds below it), so clamp after
    # a few draws instead of looping forever
    target_area = 0
    for _ in range(8):
        ratio = rng.uniform(min_area, max_area)
        target_area = int(comp_area * ratio)
        if target_area >= min_thresh:
            break
    else:
        target_area = min(comp_area, min_thresh)

    sub = np.zeros_like(component)
    rows, cols = np.where(component == 1)
    start = rng.choice(list(zip(rows.tolist(), cols.tolist())))
    stack = [start]
    h, w = component.shape
    while stack:
        y, x = stack.pop()
        sub[y, x] = 1
        if sub.sum() >= target_area:
            break
        neigh = [(y + dy, x + dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        rng.shuffle(neigh)
        for ny, nx in neigh:
            if 0 <= ny < h and 0 <= nx < w and component[ny, nx] == 1 \
                    and sub[ny, nx] == 0:
                stack.append((ny, nx))
    return sub.astype(mask.dtype), True


def _connected_components(mask: np.ndarray) -> np.ndarray:
    """4-connected labeling, used when cv2 is not installed."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    cur = 0
    for sy in range(h):
        for sx in range(w):
            if mask[sy, sx] and not labels[sy, sx]:
                cur += 1
                stack = [(sy, sx)]
                labels[sy, sx] = cur
                while stack:
                    y, x = stack.pop()
                    for ny, nx in ((y-1, x), (y+1, x), (y, x-1), (y, x+1)):
                        if 0 <= ny < h and 0 <= nx < w and mask[ny, nx] \
                                and not labels[ny, nx]:
                            labels[ny, nx] = cur
                            stack.append((ny, nx))
    return labels


def load_image_rgb(path: str) -> np.ndarray:
    """cv2 BGR read + RGB convert, or PIL where cv2 is not installed."""
    try:
        import cv2
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    img = cv2.imread(path)
    if img is None:
        raise IOError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def unpad_and_resize_mask(mask_logits: np.ndarray, resize_hw, original_hw):
    """Crop the centered valid region of [H, W] mask logits in the padded
    SAM frame, then bilinear-resize it to the original image size (PIL
    mode "F")."""
    fh, fw = mask_logits.shape
    pad_h, pad_w = fh - resize_hw[0], fw - resize_hw[1]
    top, left = pad_h // 2, pad_w // 2
    crop = mask_logits[top:top + resize_hw[0], left:left + resize_hw[1]]
    return pil_bilinear_resize(np.ascontiguousarray(crop, np.float32),
                               int(original_hw[0]), int(original_hw[1]))
