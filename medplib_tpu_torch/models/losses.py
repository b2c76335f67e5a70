"""Training losses (medplib_tpu/models/losses.py): shifted next-token cross
entropy and the mask losses (BCE, Dice, IoU, focal), all in float32, with
masked means over the valid masks. Under a mesh the sums and counts run
over the global batch (parallel/mesh.row_sum), so every rank gets the
one-process loss of the whole batch."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import IGNORE_INDEX
from medplib_tpu_torch.parallel.mesh import row_shards, row_sum


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Shifted next-token CE, mean over targets that are not IGNORE_INDEX
    (a batch with none gives 0)."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = shift_labels.clamp(min=0).long()
    logp = F.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return row_sum(nll.sum()) / row_sum(valid.sum()).clamp(min=1)


def _masked_mean(per_mask: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        if row_shards() == 1:
            return per_mask.mean()
        n = per_mask.numel() * row_shards()
        return row_sum(per_mask.sum()) / n
    v = valid.float()
    return row_sum((per_mask * v).sum()) / (row_sum(v.sum()) + 1e-8)


def sigmoid_ce_loss(pred: torch.Tensor, target: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over masks of the per-mask pixel-mean BCE-with-logits.
    pred / target [N, H, W]; valid [N] bool."""
    p, t = pred.float(), target.float()
    per_pix = p.clamp(min=0) - p * t + torch.log1p(torch.exp(-p.abs()))
    return _masked_mean(per_pix.reshape(per_pix.shape[0], -1).mean(-1), valid)


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              valid: Optional[torch.Tensor] = None,
              eps: float = 1e-6) -> torch.Tensor:
    """1 - Dice score per mask, masked mean over masks."""
    p = torch.sigmoid(pred.float()).reshape(pred.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    inter = (p * t).sum(-1)
    union = p.sum(-1) + t.sum(-1)
    return _masked_mean(1.0 - (2.0 * inter + eps) / (union + eps), valid)


def mask_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                  pred_iou: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(soft IoU - predicted IoU)^2 per mask, masked mean over masks."""
    p = torch.sigmoid(pred.float()).reshape(pred.shape[0], -1)
    t = target.float().reshape(target.shape[0], -1)
    inter = (p * t).sum(-1)
    union = p.sum(-1) + t.sum(-1) - inter
    iou = (inter + 1e-7) / (union + 1e-7)
    return _masked_mean((iou - pred_iou.reshape(-1).float()) ** 2, valid)


def focal_loss(pred: torch.Tensor, target: torch.Tensor,
               valid: Optional[torch.Tensor] = None, gamma: float = 2.0,
               alpha: float = 0.25) -> torch.Tensor:
    """Sigmoid focal loss, normalized by the pixel count of each mask."""
    p = torch.sigmoid(pred.float())
    t = target.float()
    loss_pos = -alpha * t * (1 - p) ** gamma * torch.log(p + 1e-12)
    loss_neg = -(1 - alpha) * (1 - t) * p ** gamma * torch.log(1 - p + 1e-12)
    per_mask = (loss_pos + loss_neg).reshape(pred.shape[0], -1).mean(-1)
    return _masked_mean(per_mask, valid)
