"""Segmentation metrics (medplib_tpu/eval/seg_metrics.py), numpy only:
eval-side per-sample IoU / Dice with sigmoid > 0.1 binarization and
per-modality aggregation keyed by filename prefix; train-side gIoU / cIoU
from histogram intersections and unions.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SIGMOID_THRESHOLD = 0.1  # vqa_infer.py:565

# MeCoVQA modality prefixes (vqa_infer.py keys masks by filename prefix)
MODALITIES = ("ct", "mr", "x_ray", "ultrasound", "endoscopy", "dermoscopy",
              "fundus", "pet")


def binarize_logits(mask_logits: np.ndarray,
                    threshold: float = SIGMOID_THRESHOLD) -> np.ndarray:
    prob = 1.0 / (1.0 + np.exp(-mask_logits.astype(np.float64)))
    return (prob > threshold).astype(np.uint8)


def sample_iou_dice(pred_logits: np.ndarray,
                    gt_mask: np.ndarray) -> Tuple[float, float]:
    """IoU of binarized prediction vs binary gt; Dice = 2*IoU/(1+IoU)
    (vqa_infer.py:586-591)."""
    pred = binarize_logits(pred_logits)
    gt = (gt_mask > 0).astype(np.uint8)
    inter = float(np.logical_and(pred, gt).sum())
    union = float(np.logical_or(pred, gt).sum())
    iou = inter / union if union > 0 else (1.0 if inter == 0 else 0.0)
    dice = 2.0 * iou / (1.0 + iou)
    return iou, dice


def modality_of(image_path: Optional[str]) -> str:
    if not image_path:
        return "unknown"
    name = image_path.split("/")[-1].lower()
    for m in MODALITIES:
        if name.startswith(m):
            return m
    return name.split("_")[0] if "_" in name else "unknown"


def evaluate_seg(records: Sequence[dict]) -> Dict:
    """records: dicts with 'pred_logits' [H,W], 'gt_mask' [H,W],
    'image_path'. -> overall + per-modality mIoU/mDice (in %)."""
    per_mod = collections.defaultdict(list)
    all_scores = []
    for r in records:
        iou, dice = sample_iou_dice(np.asarray(r["pred_logits"]),
                                    np.asarray(r["gt_mask"]))
        all_scores.append((iou, dice))
        per_mod[modality_of(r.get("image_path"))].append((iou, dice))

    def agg(scores):
        if not scores:
            return {"miou": 0.0, "mdice": 0.0, "n": 0}
        ious, dices = zip(*scores)
        return {"miou": 100.0 * float(np.mean(ious)),
                "mdice": 100.0 * float(np.mean(dices)),
                "n": len(scores)}

    out = agg(all_scores)
    out["per_modality"] = {m: agg(s) for m, s in sorted(per_mod.items())}
    return out


def intersection_and_union(pred: np.ndarray, target: np.ndarray,
                           num_classes: int = 2, ignore_index: int = 255):
    """Histogram intersection/union (utils/utils.py:92-104)."""
    pred = pred.reshape(-1).copy()
    target = target.reshape(-1)
    pred[target == ignore_index] = ignore_index
    inter = pred[pred == target]
    area_inter = np.histogram(inter, bins=num_classes,
                              range=(0, num_classes - 1))[0]
    area_pred = np.histogram(pred, bins=num_classes,
                             range=(0, num_classes - 1))[0]
    area_target = np.histogram(target, bins=num_classes,
                               range=(0, num_classes - 1))[0]
    return area_inter, area_pred + area_target - area_inter, area_target


class SegMeter:
    """Running gIoU/cIoU across a validation pass
    (train_ds_medplib.py:721-795): gIoU = mean of per-sample IoUs, cIoU =
    IoU of summed intersections/unions."""

    def __init__(self, num_classes: int = 2):
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.inter_sum = np.zeros(self.num_classes)
        self.union_sum = np.zeros(self.num_classes)
        self.iou_sum = np.zeros(self.num_classes)
        self.count = 0

    def update(self, pred_mask: np.ndarray, gt_mask: np.ndarray):
        inter, union, _ = intersection_and_union(
            (pred_mask > 0).astype(np.int64), (gt_mask > 0).astype(np.int64),
            self.num_classes)
        self.inter_sum += inter
        self.union_sum += union
        self.iou_sum += inter / np.maximum(union, 1e-5)
        self.count += 1

    def results(self) -> Dict[str, float]:
        if self.count == 0:
            return {"giou": 0.0, "ciou": 0.0}
        class_iou = self.inter_sum / np.maximum(self.union_sum, 1e-10)
        giou = self.iou_sum / self.count
        return {"giou": float(giou[1]), "ciou": float(class_iou[1])}
