"""Evaluation loop (medplib_tpu/eval/infer.py): chunked data-parallel VQA
and pixel-grounding inference.

Walks a test JSON in `num_chunks` / `chunk_idx` shards (each chunk is one
process on one device), runs `Evaluator.run(dataset, mode="vqa")`
(free-text answers) or `mode="seg"` (masks + IoU / Dice) through
models/medplib.generate, writes one answers-jsonl line per sample and
returns the metrics. Batches keep a static size: the final partial batch
is padded with its last sample, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.data.dataset import (CollatorConfig, collate,
                                            to_model_batch)
from medplib_tpu_torch.eval import seg_metrics, vqa_metrics
from medplib_tpu_torch.models import medplib


def get_chunk(items: Sequence, num_chunks: int, chunk_idx: int) -> List:
    """Contiguous chunking: ceil(n / num_chunks) items per chunk, empty
    chunks at the end."""
    import math
    size = math.ceil(len(items) / num_chunks)
    chunks = [items[i:i + size] for i in range(0, len(items), size)]
    while len(chunks) < num_chunks:
        chunks.append([])
    return chunks[chunk_idx]


def truncate_prompt_at_colon(ids: np.ndarray, colon_id: int = 29901):
    """Cut the teacher-forced answer off at the last ':' token so generation
    starts at 'ASSISTANT:'."""
    pos = np.where(ids == colon_id)[0]
    if len(pos) == 0:
        return ids
    return ids[: pos[-1] + 1]


@dataclass
class EvalConfig:
    num_chunks: int = 1
    chunk_idx: int = 0
    batch_size: int = 4
    max_new_tokens: int = 128
    colon_token_id: int = 29901  # llama ':'
    seg_threshold: float = seg_metrics.SIGMOID_THRESHOLD
    output_path: str = "answers.jsonl"
    vis_dir: Optional[str] = None


class Evaluator:
    """collate_fn: makes the batch arrays (default data/dataset.collate; ICL
    evaluation passes data/icl_dataset.collate_icl). Batches go to
    `device`; generate runs eagerly on it."""

    def __init__(self, cfg: MedplibConfig, params, tokenizer,
                 ecfg: EvalConfig, collator: CollatorConfig,
                 rp_flag: bool = False, collate_fn=None, device="cuda"):
        self.cfg, self.params, self.tok = cfg, params, tokenizer
        self.ecfg, self.cc = ecfg, collator
        self.rp_flag = rp_flag
        self.collate_fn = collate_fn or collate
        self.device = device
        self.eos_id = (tokenizer.eos_token_id
                       if hasattr(tokenizer, "eos_token_id") else 2)

    def _gen(self, batch):
        return medplib.generate(
            self.params, self.cfg, batch,
            max_new_tokens=self.ecfg.max_new_tokens, eos_id=self.eos_id,
            rp_flag=self.rp_flag)

    def _decode(self, ids: np.ndarray, n: int) -> str:
        ids = [int(t) for t in ids[:n] if t > 0]
        return self.tok.decode(ids, skip_special_tokens=False).replace(
            "</s>", "").strip()

    def _prepare_samples(self, samples, truncate: bool):
        if truncate:
            for s in samples:
                s = dict(s)
                s["input_ids"] = truncate_prompt_at_colon(
                    np.asarray(s["input_ids"]), self.ecfg.colon_token_id)
                s["labels"] = s["labels"][: len(s["input_ids"])]
                yield s
        else:
            yield from samples

    def run(self, dataset, mode: str = "vqa") -> Dict:
        """mode: 'vqa' (free-text answers + VQA metrics) or 'seg' (masks +
        IoU / Dice). Writes one jsonl line per sample."""
        idxs = get_chunk(list(range(len(dataset))), self.ecfg.num_chunks,
                         self.ecfg.chunk_idx)
        ecfg = self.ecfg
        records = []
        os.makedirs(os.path.dirname(os.path.abspath(ecfg.output_path)),
                    exist_ok=True)
        B = ecfg.batch_size
        with open(ecfg.output_path, "w") as fout:
            for start in range(0, len(idxs), B):
                batch_idxs = idxs[start:start + B]
                samples = [dataset[i] for i in batch_idxs]
                samples = list(self._prepare_samples(samples, truncate=True))
                while len(samples) < B:  # pad the final partial batch
                    samples.append(samples[-1])
                arrays, meta = self.collate_fn(samples, self.cc)
                res = self._gen(to_model_batch(arrays, self.device))
                out_ids = res.output_ids.cpu().numpy()
                n_gen = res.num_generated.cpu().numpy()
                masks = res.pred_masks.float().cpu().numpy()
                for j, i in enumerate(batch_idxs):
                    rec = self._record(i, j, out_ids, n_gen, masks, meta,
                                       mode, records)
                    fout.write(json.dumps(
                        {k: v for k, v in rec.items()
                         if not isinstance(v, np.ndarray)}) + "\n")
        if mode == "seg":
            return seg_metrics.evaluate_seg(records)
        return vqa_metrics.evaluate_vqa(records)

    def _record(self, i, j, out_ids, n_gen, masks, meta, mode, records):
        """Row j of a batch (sample i) -> its jsonl record; appends what
        the metrics read to `records`."""
        rec = {
            "question_id": int(i),
            "text": self._decode(out_ids[j], int(n_gen[j])),
            "gt": (meta["gt_text"][j] or [""])[-1],
            "answer_type": meta["answer_type"][j] or "open",
            "image_path": meta["image_path"][j],
        }
        if mode != "seg":
            records.append(rec)
            return rec
        gt_orig = (meta["gt_masks_original"][j] or [None])[0]
        if gt_orig is not None and meta["resize_hw"][j]:
            pred = pp.unpad_and_resize_mask(masks[j, 0], meta["resize_hw"][j],
                                            gt_orig.shape)
            iou, dice = seg_metrics.sample_iou_dice(pred, gt_orig)
            rec.update(iou=iou, dice=dice)
            records.append({"pred_logits": pred, "gt_mask": gt_orig,
                            "image_path": rec["image_path"]})
            if self.ecfg.vis_dir:
                self._save_vis(self.ecfg.vis_dir, i, pred, gt_orig,
                               rec.get("image_path"))
        return rec

    def _save_vis(self, vis_dir, idx, pred_logits, gt, image_path=None):
        """Side-by-side [original | gt overlay | pred overlay] panel blended
        onto the source image; raw pred / gt PNGs when the source is not
        readable."""
        from PIL import Image
        os.makedirs(vis_dir, exist_ok=True)
        pred = seg_metrics.binarize_logits(pred_logits).astype(bool)
        gtb = gt > 0
        img = None
        if image_path and os.path.exists(str(image_path)):
            try:
                img = np.asarray(Image.open(image_path).convert("RGB"))
            except OSError:   # unreadable or not an image
                img = None
        if img is None:
            Image.fromarray((pred * 255).astype(np.uint8)).save(
                os.path.join(vis_dir, f"{idx}_pred.png"))
            Image.fromarray((gtb * 255).astype(np.uint8)).save(
                os.path.join(vis_dir, f"{idx}_gt.png"))
            return
        if img.shape[:2] != pred.shape:
            img = np.asarray(Image.fromarray(img).resize(
                (pred.shape[1], pred.shape[0])))
        color = np.array([118, 158, 224], np.float32)  # overlay blue

        def blend(mask):
            ov = np.zeros_like(img, np.float32)
            ov[mask] = color
            out = img.astype(np.float32) * 0.5 + ov * 0.9
            return np.clip(out, 0, 255).astype(np.uint8)

        panel = np.concatenate([img, blend(gtb), blend(pred)], axis=1)
        Image.fromarray(panel).save(
            os.path.join(vis_dir, f"{idx}_overlay.png"))


def merge_chunk_outputs(paths: Sequence[str], out_path: str):
    """Concatenate per-chunk jsonl shards."""
    with open(out_path, "w") as out:
        for p in paths:
            with open(p) as f:
                out.write(f.read())
