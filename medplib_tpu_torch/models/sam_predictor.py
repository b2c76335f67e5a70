"""SAM predictor and automatic mask generation on SAM-Med2D
(medplib_tpu/models/sam_predictor.py).

SamPredictor: set_image caches the image embedding, predict decodes point
/ box / mask prompts. generate_masks prompts a point grid on the image
and on an optional crop pyramid; all grid points of a crop decode in one
mask-decoder call, then predicted-IoU and stability filters, box NMS per
crop and across crops, optional small-region cleanup and RLE output
(models/amg.py). The predictor runs on the device of its parameters;
masks come back as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from medplib_tpu_torch.config import SamConfig
from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.models import amg, sam_med2d


class SamPredictor:
    def __init__(self, params: Dict, cfg: Optional[SamConfig] = None):
        self.params = params
        self.cfg = cfg or SamConfig()
        self.device = params["mask_decoder"]["iou_token"].device
        self.reset_image()

    def reset_image(self):
        self.features = None
        self.original_hw = None
        self.resize_hw = None

    @torch.no_grad()
    def set_image(self, image_rgb: np.ndarray):
        """Compute and cache the image embedding."""
        pixels, self.resize_hw = pp.preprocess_sam(image_rgb,
                                                   self.cfg.image_size)
        self.original_hw = image_rgb.shape[:2]
        self.features = sam_med2d.encode_image(
            self.params["image_encoder"],
            torch.from_numpy(pixels)[None].to(self.device), self.cfg)

    @torch.no_grad()
    def _decode(self, features, sparse, dense, multimask: bool):
        """-> (mask logits at the input size [B, M, S, S], iou [B, M],
        low-res logits [B, M, 4h, 4w])."""
        pe = sam_med2d.dense_pe(self.params["prompt_encoder"], self.cfg)
        low_res, iou = sam_med2d.decode_masks(
            self.params["mask_decoder"], self.cfg, features, pe, sparse,
            dense, multimask_output=multimask)
        masks = sam_med2d.postprocess_masks(low_res, self.cfg.image_size)
        return masks, iou, low_res

    def _transform_coords(self, coords: np.ndarray) -> np.ndarray:
        """Original-image (x, y) -> model-input frame (resize + center pad)."""
        oh, ow = self.original_hw
        rh, rw = self.resize_hw
        scale = rh / oh
        top = (self.cfg.image_size - rh) // 2
        left = (self.cfg.image_size - rw) // 2
        out = coords.astype(np.float32) * scale
        out[..., 0] += left
        out[..., 1] += top
        return out

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    @torch.no_grad()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True):
        """-> (masks [M, H, W] bool at the original size, iou [M],
        low_res [M, h', w']), numpy."""
        assert self.features is not None, "call set_image first"
        points = None
        if point_coords is not None:
            pc = self._transform_coords(np.asarray(point_coords))[None]
            points = (self._t(pc),
                      self._t(np.asarray(point_labels, np.float32)[None]))
        boxes = None
        if box is not None:
            b = np.asarray(box, np.float32).reshape(2, 2)
            boxes = self._t(self._transform_coords(b).reshape(1, 4))
        mi = None
        if mask_input is not None:
            mi = self._t(mask_input.astype(np.float32)[None, :, :, None])
        sparse, dense = sam_med2d.encode_prompts(
            self.params["prompt_encoder"], self.cfg, 1, points=points,
            boxes=boxes, mask_input=mi)
        masks, iou, low_res = self._decode(self.features, sparse, dense,
                                           multimask_output)
        out = [pp.unpad_and_resize_mask(m, self.resize_hw,
                                        self.original_hw) > 0
               for m in masks[0].float().cpu().numpy()]
        return (np.stack(out), iou[0].float().cpu().numpy(),
                low_res[0].float().cpu().numpy())


def calculate_stability_score(mask_logits: np.ndarray,
                              mask_threshold: float = 0.0,
                              offset: float = 1.0) -> np.ndarray:
    """IoU between the binarizations at (thresh + offset) and
    (thresh - offset): high means the mask is insensitive to the cutoff.
    mask_logits: [N, H, W] float."""
    inter = (mask_logits > (mask_threshold + offset)).reshape(
        mask_logits.shape[0], -1).sum(-1).astype(np.float64)
    union = (mask_logits > (mask_threshold - offset)).reshape(
        mask_logits.shape[0], -1).sum(-1).astype(np.float64)
    return inter / np.maximum(union, 1)


def _mask_to_box(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool -> XYXY boxes [N, 4] (empty masks -> zero box)."""
    n, h, w = masks.shape
    any_x = masks.any(axis=1)  # [N, W] column occupancy
    any_y = masks.any(axis=2)  # [N, H] row occupancy
    nonempty = any_x.any(axis=1)
    xi = np.arange(w)[None, :]
    yi = np.arange(h)[None, :]
    x0 = np.where(any_x, xi, w).min(axis=1)
    x1 = np.where(any_x, xi, -1).max(axis=1) + 1
    y0 = np.where(any_y, yi, h).min(axis=1)
    y1 = np.where(any_y, yi, -1).max(axis=1) + 1
    boxes = np.stack([x0, y0, x1, y1], axis=1).astype(np.float32)
    boxes[~nonempty] = 0
    return boxes


def _box_nms(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float) -> List[int]:
    """Greedy XYXY box NMS (torchvision.ops.nms semantics): the pairwise
    IoU matrix by broadcasting, then one suppression pass."""
    n = len(boxes)
    if n == 0:
        return []
    order = np.argsort(-scores)
    b = boxes[order]
    areas = np.maximum(b[:, 2] - b[:, 0], 0) * \
        np.maximum(b[:, 3] - b[:, 1], 0)
    x0 = np.maximum(b[:, None, 0], b[None, :, 0])
    y0 = np.maximum(b[:, None, 1], b[None, :, 1])
    x1 = np.minimum(b[:, None, 2], b[None, :, 2])
    y1 = np.minimum(b[:, None, 3], b[None, :, 3])
    inter = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    union = areas[:, None] + areas[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
    suppressed = np.zeros(n, bool)
    keep: List[int] = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(int(order[i]))
        suppressed |= iou[i] >= iou_thresh
        suppressed[i] = True
    return keep


def _crop_boxes(h: int, w: int, n_layers: int,
                overlap_ratio: float) -> List[Tuple[int, int, int, int, int]]:
    """Crop pyramid: layer 0 is the full image; layer i has (2^i)^2
    overlapping crops."""
    import math
    boxes = [(0, 0, w, h, 0)]
    short = min(h, w)
    for layer in range(1, n_layers + 1):
        n = 2 ** layer
        overlap = int(overlap_ratio * short * (2 / n))
        cw = int(math.ceil((overlap * (n - 1) + w) / n))
        ch = int(math.ceil((overlap * (n - 1) + h) / n))
        for yi in range(n):
            for xi in range(n):
                x0 = int((cw - overlap) * xi)
                y0 = int((ch - overlap) * yi)
                boxes.append((x0, y0, min(x0 + cw, w), min(y0 + ch, h),
                              layer))
    return boxes


@torch.no_grad()
def _process_crop(predictor: SamPredictor, crop_img: np.ndarray,
                  points_per_side: int, pred_iou_thresh: float,
                  stability_score_thresh: float,
                  stability_score_offset: float, box_nms_thresh: float,
                  min_area: int) -> List[Dict]:
    """Grid-prompt one image (or crop): batched single-point decode ->
    predicted-IoU filter -> stability filter -> binarize -> box NMS.
    Returns records with crop-frame masks and boxes."""
    cfg = predictor.cfg
    predictor.set_image(crop_img)
    h, w = crop_img.shape[:2]
    xs = (np.arange(points_per_side) + 0.5) / points_per_side * w
    ys = (np.arange(points_per_side) + 0.5) / points_per_side * h
    grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)  # [P, 2] (x, y)

    n_pts = grid.shape[0]
    pc = predictor._transform_coords(grid)[:, None, :]      # [P, 1, 2]
    labels = torch.ones((n_pts, 1), device=predictor.device)
    sparse, dense = sam_med2d.encode_prompts(
        predictor.params["prompt_encoder"], cfg, n_pts,
        points=(predictor._t(pc), labels))
    feats = predictor.features.expand(n_pts, -1, -1, -1)
    masks, ious, _ = predictor._decode(feats, sparse, dense, True)
    masks = masks.float().cpu().numpy()     # [P, 3, S, S] logits
    ious = ious.float().cpu().numpy()       # [P, 3]

    flat_masks = masks.reshape(-1, masks.shape[-2], masks.shape[-1])
    flat_iou = ious.reshape(-1)
    keep = flat_iou > pred_iou_thresh
    flat_masks, flat_iou = flat_masks[keep], flat_iou[keep]
    if len(flat_masks) == 0:
        return []
    # stability filter on the mask logits
    stability = calculate_stability_score(flat_masks,
                                          offset=stability_score_offset)
    keep = stability >= stability_score_thresh
    flat_masks, flat_iou, stability = (flat_masks[keep], flat_iou[keep],
                                       stability[keep])
    if len(flat_masks) == 0:
        return []
    binary = np.stack([
        pp.unpad_and_resize_mask(m, predictor.resize_hw,
                                 predictor.original_hw) > 0
        for m in flat_masks])
    areas = binary.reshape(binary.shape[0], -1).sum(-1)
    big = areas >= min_area
    binary, flat_iou, stability = binary[big], flat_iou[big], stability[big]
    if len(binary) == 0:
        return []
    boxes = _mask_to_box(binary)
    sel = _box_nms(boxes, flat_iou, box_nms_thresh)
    return [{"segmentation": binary[i], "bbox": boxes[i],
             "predicted_iou": float(flat_iou[i]),
             "stability_score": float(stability[i]),
             "area": int(binary[i].sum())} for i in sel]


def generate_masks(predictor: SamPredictor, image_rgb: np.ndarray,
                   points_per_side: int = 16, pred_iou_thresh: float = 0.88,
                   stability_score_thresh: float = 0.95,
                   stability_score_offset: float = 1.0,
                   box_nms_thresh: float = 0.7,
                   nms_iou_thresh: Optional[float] = None,
                   min_area: int = 16, crop_n_layers: int = 0,
                   crop_overlap_ratio: float = 512 / 1500,
                   crop_n_points_downscale_factor: int = 1,
                   min_mask_region_area: int = 0,
                   output_mode: str = "binary_mask") -> List[Dict]:
    """Automatic mask generation: optional crop pyramid -> per-crop point
    grid -> batched single-point decode -> predicted-IoU + stability-score
    filters -> per-crop box NMS -> cross-crop NMS preferring smaller
    crops.

    min_mask_region_area > 0 also fills holes / drops islands smaller
    than that area and re-deduplicates (amg.postprocess_small_regions).
    output_mode selects the "segmentation" payload: "binary_mask" ([H, W]
    bool), "uncompressed_rle" (pycocotools-style counts dict) or
    "coco_rle" (compressed counts string, encoded by models/amg.py)."""
    assert output_mode in ("binary_mask", "uncompressed_rle", "coco_rle"), \
        f"unknown output_mode {output_mode}"
    h, w = image_rgb.shape[:2]
    # the legacy alias, resolved once so per-crop NMS and cross-crop
    # dedup use the same threshold
    if nms_iou_thresh is not None:
        box_nms_thresh = nms_iou_thresh
    crops = _crop_boxes(h, w, crop_n_layers, crop_overlap_ratio)
    records: List[Dict] = []
    for (x0, y0, x1, y1, layer) in crops:
        pps = max(1, points_per_side //
                  (crop_n_points_downscale_factor ** layer))
        crop_img = image_rgb[y0:y1, x0:x1]
        recs = _process_crop(
            predictor, crop_img, pps, pred_iou_thresh,
            stability_score_thresh, stability_score_offset,
            box_nms_thresh, min_area)
        for r in recs:
            # paste the crop-frame mask back into the full image frame
            if (x0, y0, x1, y1) != (0, 0, w, h):
                full = np.zeros((h, w), bool)
                full[y0:y1, x0:x1] = r["segmentation"]
                r["segmentation"] = full
                r["bbox"] = r["bbox"] + np.array([x0, y0, x0, y0],
                                                 np.float32)
            r["crop_box"] = (x0, y0, x1, y1)
            # cross-crop dedup prefers masks from smaller crops
            r["_crop_score"] = 1.0 / max((x1 - x0) * (y1 - y0), 1)
        records.extend(recs)
    if not records:
        return []
    if crop_n_layers > 0 and len(records) > 1:
        boxes = np.stack([r["bbox"] for r in records])
        scores = np.array([r["_crop_score"] for r in records])
        keep = _box_nms(boxes, scores, box_nms_thresh)
        records = [records[i] for i in keep]
    for r in records:
        r.pop("_crop_score", None)
    if min_mask_region_area > 0:
        records = amg.postprocess_small_regions(records, min_mask_region_area,
                                                box_nms_thresh)
    if output_mode != "binary_mask":
        for r in records:
            rle = amg.mask_to_rle(np.asarray(r["segmentation"], bool))
            r["segmentation"] = (amg.coco_encode_rle(rle)
                                 if output_mode == "coco_rle" else rle)
    return records
