"""MedPLIB-ICL dataset: 1-3 in-context (image, mask) example pairs
(medplib_tpu/data/icl_dataset.py).

Examples come from `icl_examples` / `examples` lists or `imageN` / `maskN`
keys, in one of three encodings:
  overlay:  the mask blended in blue into the example image;
  separate: the mask rendered as an extra CLIP image;
  separate + mask encoder: the mask as a mask-encoder input.
A record without a usable conversation gets a default one, and every
sample carries per-slot token types and lengths for the mixed image /
mask splice. Example masks load through Pillow (nearest-neighbour resize
to the image), as in the JAX package.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Dict, List, Optional

import numpy as np

from medplib_tpu_torch.config import IGNORE_INDEX
from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.data import tokenize as tk
from medplib_tpu_torch.data.dataset import (CollatorConfig, DataConfig,
                                      LazySupervisedDataset, MASK_PATTERN,
                                      extract_masks)

OVERLAY_COLOR = np.array([118, 158, 224], np.float32)
MASK_TAG = re.compile(r"<mask>(.*?)</mask>")


class ICLLazySupervisedDataset(LazySupervisedDataset):
    def __init__(self, cfg: DataConfig, tokenizer, train: bool = True,
                 mask_mode: str = "overlay", use_mask_encoder: bool = False,
                 image_tokens: int = 576, mask_tokens: int = 64,
                 max_examples: int = 3,
                 mask_input_size: Optional[int] = None):
        """max_examples: MedplibConfig.max_icl_examples — cap on in-context
        (image, mask) pairs per sample. mask_input_size:
        ProjectorConfig.mask_input_size — the frame example masks are
        rendered at for the mask encoder (defaults to the CLIP size)."""
        super().__init__(cfg, tokenizer, train)
        assert mask_mode in ("overlay", "separate")
        self.mask_mode = mask_mode
        self.use_mask_encoder = use_mask_encoder and mask_mode == "separate"
        self.image_tokens = image_tokens
        self.mask_tokens = mask_tokens
        self.max_examples = max_examples
        self.mask_input_size = mask_input_size or cfg.clip_image_size

    # ---- example resolution ----
    def _flat_examples(self, source: Dict) -> List[Dict[str, str]]:
        examples = source.get("icl_examples", source.get("examples", []))
        if examples:
            return examples[: self.max_examples]
        indexed = sorted(int(k[len("image"):]) for k in source
                         if k.startswith("image") and k[len("image"):].isdigit())
        if not indexed:
            return []
        target_idx = None
        if "image" not in source:
            target_idx = indexed[-1]
            source.setdefault("image", source[f"image{target_idx}"])
            if f"mask{target_idx}" in source:
                source.setdefault("target_mask", source[f"mask{target_idx}"])
        out = [{"image": source[f"image{i}"], "mask": source[f"mask{i}"]}
               for i in indexed
               if i != target_idx and f"mask{i}" in source]
        return out[: self.max_examples]

    def _expected_image_tokens(self, n: int) -> int:
        """separate mode uses one <image> sentinel per example image AND one
        per mask (even in mask-encoder mode); overlay uses one per example."""
        return n * 2 + 1 if self.mask_mode == "separate" else n + 1

    def _default_conversation(self, source: Dict, n: int):
        blocks = []
        if self.mask_mode == "separate":
            for i in range(n):
                blocks.append(f"Example {i + 1} image: <image>\n"
                              f"Example {i + 1} mask: <image>")
        else:
            for i in range(n):
                blocks.append(
                    f"Example {i + 1}: <image>\nThe blue overlay is the "
                    "reference segmentation mask.")
        blocks.append("Query: <image>\nRefer to the previous examples and "
                      "segment the corresponding target in this image.")
        answer = "<SEG>"
        target_mask = source.get("target_mask",
                                 source.get("mask", source.get("mask3")))
        if target_mask is not None:
            answer += f"<mask>{target_mask}</mask>"
        return [{"from": "human", "value": "\n".join(blocks)},
                {"from": "gpt", "value": answer}]

    def _prepare_source(self, source: Dict, n: int) -> Dict:
        source = copy.deepcopy(source)
        count = sum(str(t.get("value", "")).count("<image>")
                    for t in source.get("conversations", []))
        if "conversations" not in source or count < self._expected_image_tokens(n):
            source["conversations"] = self._default_conversation(source, n)
        elif not any(MASK_TAG.search(str(t.get("value", "")))
                     for t in source["conversations"]):
            target = source.get("target_mask",
                                source.get("mask", source.get("mask3")))
            if target is not None:
                source["conversations"][-1]["value"] = (
                    str(source["conversations"][-1]["value"]) +
                    f"<mask>{target}</mask>")
        return source

    # ---- image encodings ----
    def _overlay(self, rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = rgb.astype(np.float32)
        out[mask > 0] = out[mask > 0] * 0.45 + OVERLAY_COLOR * 0.55
        return np.clip(out, 0, 255).astype(np.uint8)

    def _resolve(self, name: str) -> str:
        if os.path.exists(name):
            return name
        return os.path.join(self.cfg.image_folder, name)

    def _load_mask(self, name: str, target_hw=None) -> np.ndarray:
        from PIL import Image
        m = np.asarray(Image.open(self._resolve(name)).convert("L"))
        if target_hw is not None and m.shape[:2] != tuple(target_hw):
            m = np.asarray(Image.fromarray(m).resize(
                (target_hw[1], target_hw[0]), Image.NEAREST))
        return (m >= 1).astype(np.uint8)

    def __getitem__(self, i: int) -> Dict:
        raw = self.records[i]
        examples = self._flat_examples(raw)
        assert 1 <= len(examples) <= self.max_examples, (
            f"ICL needs 1-{self.max_examples} examples")
        source = self._prepare_source(raw, len(examples))
        cfg = self.cfg

        seg_masks = extract_masks(source, cfg.image_folder, MASK_PATTERN,
                                  strip_tag=True)

        target_file = source.get("image", source.get("image3"))
        rgb = pp.load_image_rgb(self._resolve(target_file))
        image_sam, resize_hw = pp.preprocess_sam(rgb, cfg.sam_image_size)

        # slots: (clip_image, mask_image, type, token_length) — one entry
        # per <image> sentinel, strictly aligned
        s = cfg.clip_image_size
        ms = self.mask_input_size  # ProjectorConfig.mask_input_size frame
        zero_clip = np.zeros((s, s, 3), np.float32)
        zero_mask = np.zeros((ms, ms), np.float32)
        slots = []
        for ex in examples:
            ex_rgb = pp.load_image_rgb(self._resolve(ex["image"]))
            ex_mask = self._load_mask(ex["mask"], ex_rgb.shape[:2])
            if self.mask_mode == "separate":
                slots.append((pp.preprocess_clip(ex_rgb, s), zero_mask,
                              "image", self.image_tokens))
                if self.use_mask_encoder:
                    resized = pp.resize_longest_side(
                        (ex_mask * 255).astype(np.uint8), ms)
                    padded = pp.center_pad(resized, ms, 0)
                    slots.append((zero_clip, (padded > 0).astype(np.float32),
                                  "mask", self.mask_tokens))
                else:
                    mask_rgb = np.stack([ex_mask * 255] * 3, -1).astype(
                        np.uint8)
                    slots.append((pp.preprocess_clip(mask_rgb, s), zero_mask,
                                  "image", self.image_tokens))
            else:
                slots.append((pp.preprocess_clip(
                    self._overlay(ex_rgb, ex_mask), s), zero_mask, "image",
                    self.image_tokens))
        slots.append((pp.preprocess_clip(rgb, s), zero_mask, "image",
                      self.image_tokens))
        images_clip = [sl[0] for sl in slots]
        mask_images = [sl[1] for sl in slots]
        token_types = [sl[2] for sl in slots]
        token_lengths = [sl[3] for sl in slots]

        sources = tk.preprocess_multimodal(
            [copy.deepcopy(source["conversations"])])
        d = tk.preprocess_v1(sources, self.tokenizer, self.conv,
                             has_image=True)

        gt_frame = []
        for m in seg_masks:
            resized = pp.resize_longest_side(m, cfg.sam_image_size)
            gt_frame.append(pp.center_pad(resized, cfg.sam_image_size,
                                          0).astype(np.float32))

        return {
            "input_ids": d["input_ids"][0], "labels": d["labels"][0],
            "question": d["question"], "gt": d["gt"],
            "image_clip": np.stack(images_clip),
            "mask_images": np.stack(mask_images[: len(images_clip)]),
            "image_token_types": token_types,
            "image_token_lengths": token_lengths,
            "image_sam": image_sam, "resize_hw": resize_hw,
            "original_hw": rgb.shape[:2],
            "image_path": self._resolve(target_file),
            "gt_masks": gt_frame, "gt_masks_original": seg_masks,
            "region_masks": [],
            "answer_type": source.get("answer_type"),
        }


def collate_icl(samples, cc: CollatorConfig, max_slots: int = 7,
                mask_tokens: int = 64):
    """ICL collator: per-slot CLIP images, mask-encoder inputs, token-type
    flags (DataCollatorForSupervisedDataset.py:105-108 keeps these ragged;
    here fixed max_slots = max_icl_examples * 2 + query)."""
    B = len(samples)
    T = cc.max_seq_len
    s = cc.clip_image_size
    # the mask-encoder frame follows the dataset (ProjectorConfig.
    # mask_input_size); fall back to the CLIP size for mask-free samples
    ms = (samples[0]["mask_images"].shape[-1]
          if samples and len(samples[0]["mask_images"]) else s)
    ids = np.full((B, T), cc.pad_token_id, np.int64)
    mask = np.zeros((B, T), np.int32)
    labels = np.full((B, T), IGNORE_INDEX, np.int64)
    clip = np.zeros((B, max_slots, s, s, 3), np.float32)
    mask_imgs = np.zeros((B, max_slots, ms, ms), np.float32)
    is_mask = np.zeros((B, max_slots), np.int32)
    itl = np.zeros((B, max_slots), np.int32)
    sam = np.zeros((B, cc.sam_image_size, cc.sam_image_size, 3), np.float32)
    gt = np.zeros((B, cc.max_segs, cc.sam_image_size, cc.sam_image_size),
                  np.float32)
    mask_valid = np.zeros((B, cc.max_segs), bool)
    meta = {"resize_hw": [], "original_hw": [], "question": [],
            "gt_text": [], "image_path": [], "gt_masks_original": [],
            "answer_type": []}
    for b, smp in enumerate(samples):
        n = min(len(smp["input_ids"]), T)
        ids[b, :n] = smp["input_ids"][:n]
        labels[b, :n] = smp["labels"][:n]
        mask[b, :n] = 1
        n_img = min(len(smp["image_token_lengths"]), max_slots)
        clip[b, :n_img] = smp["image_clip"][:n_img]
        mask_imgs[b, :n_img] = smp["mask_images"][:n_img]
        itl[b, :n_img] = smp["image_token_lengths"][:n_img]
        for j, t in enumerate(smp["image_token_types"][:n_img]):
            is_mask[b, j] = 1 if t == "mask" else 0
        sam[b] = smp["image_sam"]
        for g, m in enumerate(smp.get("gt_masks", [])[:cc.max_segs]):
            gt[b, g] = m
            mask_valid[b, g] = True
        for k in meta:
            key = {"gt_text": "gt"}.get(k, k)
            meta[k].append(smp.get(key))
    arrays = dict(
        input_ids=ids, input_mask=mask, labels=labels, images_clip=clip,
        images_sam=sam, image_token_lengths=itl, image_is_mask=is_mask,
        mask_images=mask_imgs, gt_masks=gt, mask_valid=mask_valid)
    return arrays, meta
