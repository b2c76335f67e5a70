"""Supervised conversation dataset + static-shape collator
(medplib_tpu/data/dataset.py): JSON conversation records with
`<mask>path</mask>` segmentation targets and `<region>path</region>`
prompt masks become fixed-shape numpy batches, and `to_model_batch` turns
them into the port's `models.medplib.Batch` on a device.

As in the JAX package: ragged per-sample lists become fixed MAX_SEG /
MAX_REG slots with validity flags, and ground-truth masks are resized
into the 256 SAM frame at load time (eval metrics use the original
resolution through data.preprocess.unpad_and_resize_mask).
"""

from __future__ import annotations

import copy
import json
import os
import random
import re
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np

from medplib_tpu_torch.config import IGNORE_INDEX
from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.data import tokenize as tk
from medplib_tpu_torch.data.conversation import conv_templates

MASK_PATTERN = re.compile(r"<mask>(.*?)</mask>")
REGION_PATTERN = re.compile(r"<region>(.*?)</region>")


@dataclass
class DataConfig:
    data_path: str = ""
    image_folder: str = ""
    conv_template: str = "llava_v1"
    sam_image_size: int = 256
    clip_image_size: int = 336
    clip_patch: int = 14
    seed: int = 42
    augment_regions: bool = True


def extract_masks(source: dict, root: str, pattern: re.Pattern,
                  strip_tag: bool):
    """Pull `<mask>name</mask>` / `<region>name</region>` refs out of the
    conversation text, load them as binary masks (Pillow, imported here:
    only the dataset reads mask files)."""
    masks = []
    for turn in source["conversations"]:
        names = pattern.findall(str(turn["value"]))
        if not names:
            continue
        assert len(names) == 1, "one mask per turn"
        path = os.path.join(root, names[0])
        from PIL import Image
        m = np.asarray(Image.open(path).convert("L"))
        masks.append((m >= 1).astype(np.uint8))
        if strip_tag:
            turn["value"] = str(turn["value"]).replace(
                f"<mask>{names[0]}</mask>", "")
        else:
            turn["value"] = str(turn["value"]).replace(names[0], "")
    return masks


class LazySupervisedDataset:
    """JSON conversations -> per-sample numpy dicts (map-style)."""

    def __init__(self, cfg: DataConfig, tokenizer, train: bool = True):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.train = train
        self.conv = conv_templates[cfg.conv_template]
        with open(cfg.data_path) as f:
            self.records = json.load(f)
        for item in self.records:
            for turn in item.get("conversations", []):
                turn["value"] = str(turn["value"])

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> Dict:
        source = copy.deepcopy(self.records[i])
        cfg = self.cfg
        seg_masks = extract_masks(source, cfg.image_folder, MASK_PATTERN,
                                  strip_tag=True)
        region_masks_raw = extract_masks(source, cfg.image_folder,
                                         REGION_PATTERN, strip_tag=False)

        region_masks = []
        region_valid = True
        for ri, m in enumerate(region_masks_raw):
            grid = pp.preprocess_region_mask(m, cfg.clip_image_size,
                                             cfg.clip_patch)
            if self.train and cfg.augment_regions:
                # per-(sample, region) rng, not a shared Mersenne state:
                # augmentation must be a pure function of (seed, index) so
                # the threaded PrefetchLoader (data/loader.py) is
                # schedule-independent and resume replay reproduces the
                # exact batches. Integer mix — random.Random rejects tuple
                # seeds on Python 3.11+.
                grid, ok = pp.sub_component_augment(
                    grid, rng=random.Random(
                        cfg.seed * 1_000_003 + i * 1009 + ri))
                region_valid = region_valid and ok
            region_masks.append(grid)

        out: Dict = {"answer_type": source.get("answer_type")}
        if "image" in source:
            path = source["image"]
            if not os.path.exists(path):
                path = os.path.join(cfg.image_folder, path)
            rgb = pp.load_image_rgb(path)
            out["original_hw"] = rgb.shape[:2]
            out["image_sam"], out["resize_hw"] = pp.preprocess_sam(
                rgb, cfg.sam_image_size)
            out["image_clip"] = pp.preprocess_clip(rgb, cfg.clip_image_size)
            out["image_path"] = path
            sources = tk.preprocess_multimodal(
                [copy.deepcopy(source["conversations"])])
            has_image = True
        else:
            sources = [copy.deepcopy(source["conversations"])]
            has_image = False

        d = tk.preprocess_v1(sources, self.tokenizer, self.conv,
                             has_image=has_image)
        out["input_ids"] = d["input_ids"][0]
        out["labels"] = d["labels"][0]
        out["question"] = d["question"]
        out["gt"] = d["gt"]

        # gt seg masks into the padded SAM frame (static-resolution loss)
        frame = []
        for m in seg_masks:
            resized = pp.resize_longest_side(m, cfg.sam_image_size)
            frame.append(pp.center_pad(resized, cfg.sam_image_size,
                                       0).astype(np.float32))
        out["gt_masks"] = frame
        out["gt_masks_original"] = seg_masks
        out["region_masks"] = region_masks
        if region_masks and not region_valid:
            # invalid region -> drop the sample's loss + dummy region
            # (LazySupervisedDataset.py:606-613)
            out["labels"] = np.full_like(out["labels"], IGNORE_INDEX)
            g = cfg.clip_image_size // cfg.clip_patch
            dummy = np.zeros((g, g), np.float32)
            dummy[:3, :3] = 1
            out["region_masks"] = [dummy]
        return out


@dataclass
class CollatorConfig:
    max_seq_len: int = 512
    max_images: int = 1
    max_regions: int = 1
    max_segs: int = 1
    image_tokens: int = 576
    sam_image_size: int = 256
    clip_image_size: int = 336
    clip_patch: int = 14
    pad_token_id: int = 0


def collate(samples: Sequence[Dict], cc: CollatorConfig):
    """-> dict of numpy arrays matching models.medplib.Batch (+ host-side
    metadata lists for eval postprocessing)."""
    B = len(samples)
    T = cc.max_seq_len
    ids = np.full((B, T), cc.pad_token_id, np.int64)
    mask = np.zeros((B, T), np.int32)
    labels = np.full((B, T), IGNORE_INDEX, np.int64)
    clip = np.zeros((B, cc.max_images, cc.clip_image_size,
                     cc.clip_image_size, 3), np.float32)
    sam = np.zeros((B, cc.sam_image_size, cc.sam_image_size, 3), np.float32)
    itl = np.zeros((B, cc.max_images), np.int32)
    grid = cc.clip_image_size // cc.clip_patch
    regions = np.zeros((B, cc.max_regions, grid, grid), np.float32)
    region_valid = np.zeros((B, cc.max_regions), bool)
    gt = np.zeros((B, cc.max_segs, cc.sam_image_size, cc.sam_image_size),
                  np.float32)
    mask_valid = np.zeros((B, cc.max_segs), bool)
    meta = {"resize_hw": [], "original_hw": [], "question": [], "gt_text": [],
            "image_path": [], "gt_masks_original": [], "answer_type": []}

    for b, s in enumerate(samples):
        n = min(len(s["input_ids"]), T)
        ids[b, :n] = s["input_ids"][:n]
        labels[b, :n] = s["labels"][:n]
        mask[b, :n] = 1
        if "image_clip" in s:
            clip[b, 0] = s["image_clip"]
            sam[b] = s["image_sam"]
            itl[b, 0] = cc.image_tokens
        for r, m in enumerate(s.get("region_masks", [])[:cc.max_regions]):
            regions[b, r] = m
            region_valid[b, r] = True
        for g, m in enumerate(s.get("gt_masks", [])[:cc.max_segs]):
            gt[b, g] = m
            mask_valid[b, g] = True
        meta["resize_hw"].append(s.get("resize_hw"))
        meta["original_hw"].append(s.get("original_hw"))
        meta["question"].append(s.get("question"))
        meta["gt_text"].append(s.get("gt"))
        meta["image_path"].append(s.get("image_path"))
        meta["gt_masks_original"].append(s.get("gt_masks_original"))
        meta["answer_type"].append(s.get("answer_type"))

    batch_arrays = dict(
        input_ids=ids, input_mask=mask, labels=labels, images_clip=clip,
        images_sam=sam, image_token_lengths=itl, region_masks=regions,
        region_valid=region_valid, gt_masks=gt, mask_valid=mask_valid)
    return batch_arrays, meta


def to_model_batch(batch_arrays: Dict, device="cuda"):
    """Collated numpy arrays -> models.medplib.Batch on `device`, with the
    dtypes the JAX package's jnp.asarray gives them (int64 -> int32,
    float64 -> float32)."""
    import torch
    from medplib_tpu_torch.models.medplib import Batch

    def dev(a):
        a = np.asarray(a)
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        elif a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Batch.make(**{k: dev(v) for k, v in batch_arrays.items()})
