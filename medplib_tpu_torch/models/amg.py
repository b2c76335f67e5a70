"""Automatic-mask-generation tail (medplib_tpu/models/amg.py): RLE codecs
and small-region cleanup.

- uncompressed RLE in the pycocotools dict format (column-major counts,
  first count the number of leading zeros), vectorized numpy;
- COCO compressed RLE ("coco_rle") encoded and decoded here (the COCO
  mask API's wire format: 5 data bits per char, 0x20 continuation flag,
  chars offset by 48, counts delta-coded against counts[i-2]), so no
  pycocotools is needed;
- small-region cleanup (hole filling and island removal below an area
  threshold, 8-connected components) with the unchanged-preferred NMS
  re-dedup pass. Components are labelled by scipy.ndimage.label with a
  3 x 3 structure and renumbered as OpenCV's connectedComponentsWithStats
  numbers them (`_label8`), so no cv2 is needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# uncompressed RLE (pycocotools dict format)
# ---------------------------------------------------------------------------

def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """[H, W] bool -> {"size": [H, W], "counts": [...]} uncompressed RLE.

    Counts run down columns (Fortran order) and start with the number of
    leading zeros (possibly 0), alternating 0-run / 1-run, the layout
    pycocotools emits. Vectorized: one flatten + one diff per mask.
    """
    h, w = mask.shape
    flat = np.asarray(mask, bool).reshape(-1, order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds)
    counts = runs.tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Uncompressed RLE -> [H, W] bool."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = (np.arange(len(counts)) % 2).astype(bool)  # 0-run, 1-run, ...
    flat = np.repeat(vals, counts)
    return flat.reshape(h, w, order="F")


def area_from_rle(rle: Dict[str, Any]) -> int:
    return int(sum(rle["counts"][1::2]))


# ---------------------------------------------------------------------------
# COCO compressed RLE string codec (the pycocotools wire format)
# ---------------------------------------------------------------------------

def _rle_counts_to_string(counts: List[int]) -> str:
    """COCO mask API compressed counts: LEB128-style, 5 data bits per
    char + 0x20 continuation bit, chars offset by 48; count i >= 3 is
    delta-coded against count i-2 (same-parity neighbor), which keeps
    the variable-length codes short for repetitive masks."""
    out = []
    for i, c in enumerate(counts):
        x = int(c) - (int(counts[i - 2]) if i > 2 else 0)
        while True:
            ch = x & 0x1F
            x >>= 5  # arithmetic shift: negatives converge to -1
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(chr(ch + 48))
            if not more:
                break
    return "".join(out)


def _rle_string_to_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k = 0, 0
        while True:
            ch = ord(s[i]) - 48
            x |= (ch & 0x1F) << k
            k += 5
            i += 1
            if not (ch & 0x20):
                if ch & 0x10:       # sign-extend the final 5-bit group
                    x |= -1 << k
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Uncompressed RLE dict -> COCO compressed form with a str `counts`
    (JSON-serializable)."""
    return {"size": list(uncompressed_rle["size"]),
            "counts": _rle_counts_to_string(uncompressed_rle["counts"])}


def coco_decode_rle(coco_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of coco_encode_rle (for round-trip tests / consumers)."""
    return {"size": list(coco_rle["size"]),
            "counts": _rle_string_to_counts(coco_rle["counts"])}


# ---------------------------------------------------------------------------
# small-region cleanup
# ---------------------------------------------------------------------------

def _label8(work: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected components of a bool [H, W] -> (labels, count + 1),
    numbered as OpenCV's 8-way block-based labelling (its default) numbers
    them: it scans 2 x 2 blocks, two rows at a time, and the four pixels of
    a block are 8-adjacent, so a component's number is the rank of the
    first block (block row, then block column) that holds one of its
    pixels. That is not the raster order of first pixels."""
    from scipy import ndimage

    labels, n = ndimage.label(work, structure=np.ones((3, 3), int))
    h, w = work.shape
    yy, xx = np.indices((h, w))
    block = (yy // 2) * ((w + 1) // 2) + xx // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels.ravel(), block.ravel())
    order = np.argsort(first[1:], kind="stable") + 1
    remap = np.zeros(n + 1, np.int64)
    remap[order] = np.arange(1, n + 1)
    return remap[labels], n + 1


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Fill small holes ("holes") or drop small islands ("islands") below
    `area_thresh` pixels, 8-connected. Returns (mask, changed). In islands
    mode, if EVERY island is small the largest one is kept so the mask
    never empties; among equally large ones the one OpenCV numbers first
    (`_label8`, computed only for that case: no other result depends on
    the numbering).
    """
    from scipy import ndimage

    assert mode in ("holes", "islands"), mode
    mask = np.asarray(mask, bool)
    # label the complement for hole analysis, the mask itself for islands
    work = ~mask if mode == "holes" else mask
    labels, n = ndimage.label(work, structure=np.ones((3, 3), int))
    sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:]  # 0: background
    small = np.flatnonzero(sizes < area_thresh) + 1
    if small.size == 0:
        return mask, False
    if mode == "holes":
        # small holes (complement components) are filled back into the mask
        return mask | np.isin(labels, small), True
    keep = np.setdiff1d(np.arange(1, n + 1), small)
    if keep.size == 0:
        labels, n = _label8(work)
        sizes = np.bincount(labels.ravel(), minlength=n)[1:]
        keep = np.array([int(np.argmax(sizes)) + 1])
    return np.isin(labels, keep), True


def postprocess_small_regions(records: List[Dict], min_area: int,
                              nms_thresh: float) -> List[Dict]:
    """Clean every record's mask (fill holes, drop islands < min_area),
    then re-run box NMS with score 1.0 for untouched masks and 0.0 for
    edited ones so duplicates created by the cleanup resolve in favor of
    masks that needed no repair.

    records: dicts with "segmentation" ([H, W] bool), "bbox", "area".
    Returns the surviving records with masks/boxes/areas updated.
    """
    from medplib_tpu_torch.models.sam_predictor import _box_nms, _mask_to_box

    if not records:
        return records
    cleaned, scores = [], []
    for r in records:
        m = np.asarray(r["segmentation"], bool)
        m, ch_holes = remove_small_regions(m, min_area, "holes")
        m, ch_islands = remove_small_regions(m, min_area, "islands")
        cleaned.append(m)
        scores.append(0.0 if (ch_holes or ch_islands) else 1.0)

    masks = np.stack(cleaned)
    boxes = _mask_to_box(masks)
    keep = _box_nms(boxes, np.asarray(scores), nms_thresh)
    out = []
    for i in keep:
        r = dict(records[i])
        if scores[i] == 0.0:  # only edited masks need their fields redone
            r["segmentation"] = masks[i]
            r["bbox"] = boxes[i]
            r["area"] = int(masks[i].sum())
        out.append(r)
    return out
