"""The traffic generator: one general generator for every mix file.

A mix (`portbench/mixes/<name>.json`) is data: batch size, text lengths,
where the image and the <SEG> sit, new tokens. Inputs come from the run's
seed and the call's index only; the program receives the generated batch
and nothing else, and the reference makes the same batch again.

kind "grounded_vqa": one image per row (the CLIP sentinel at `image_at`),
a <SEG> `seg_from_end` tokens before the row's end, right-padded to the
batch's longest row. lengths "spread": the batch's B text lengths are the
B values evenly spaced over [text_len_min, text_len_max], in an order drawn
from the seed, so every call and every seed does the same work.

kind "seg_sft": those rows as a training batch: labels (a share of each
row's first tokens masked, as instruction tuning masks the prompt) and one
ground-truth mask per row.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench.weights import key_of

IMAGE_TOKEN_INDEX = -200
ROOT = Path(__file__).resolve().parent


def load_mix(name: str, root: Path = ROOT) -> dict:
    with open(root / "mixes" / f"{name}.json") as f:
        return json.load(f)


def _rng(seed: int, call: int) -> np.random.Generator:
    return np.random.default_rng(key_of(seed, "traffic/ids", call))


def text_lengths(mix: dict, rng: np.random.Generator) -> np.ndarray:
    if mix["lengths"] != "spread":
        raise ValueError(f"unknown lengths {mix['lengths']!r}")
    lens = np.rint(np.linspace(mix["text_len_min"], mix["text_len_max"],
                               mix["batch"])).astype(np.int64)
    return rng.permutation(lens)


def grounded_vqa(mix: dict, model: dict, seed: int, call: int,
                 device) -> dict:
    """One batch of call `call`: ids [B, T] int64 (IMAGE_TOKEN_INDEX at
    the image, the <SEG> id near the end, 0 past each row's length), mask
    [B, T] int32, lens [B], clip [B, 1, S, S, 3] and sam [B, S', S', 3]
    f32 pixels as the preprocessors leave them (normalized), on `device`."""
    if mix["images_per_row"] != 1:
        raise ValueError("grounded_vqa makes one image per row")
    rng = _rng(seed, call)
    b = mix["batch"]
    lens = text_lengths(mix, rng)
    t = int(lens.max())
    bos, eos = model["bos_token_id"], model["eos_token_id"]
    seg = model["medplib"]["seg_token_idx"]
    ids = rng.integers(3, min(bos, eos), size=(b, t))
    mask = np.zeros((b, t), np.int32)
    for r, n in enumerate(lens):
        ids[r, n:] = 0
        mask[r, :n] = 1
        ids[r, 0] = bos
        ids[r, mix["image_at"]] = IMAGE_TOKEN_INDEX
        ids[r, n - mix["seg_from_end"]] = seg
    gen = torch.Generator(device=device)
    gen.manual_seed(key_of(seed, "traffic/pixels", call))
    vs = model["medplib"]["vision"]["image_size"]
    ss = model["medplib"]["sam"]["image_size"]
    clip = torch.randn((b, 1, vs, vs, 3), generator=gen, device=device)
    sam = torch.randn((b, ss, ss, 3), generator=gen, device=device)
    return {"ids": torch.as_tensor(ids, device=device),
            "mask": torch.as_tensor(mask, device=device),
            "lens": lens, "clip": clip, "sam": sam,
            "new_tokens": mix.get("new_tokens", 0)}


def seg_sft(mix: dict, model: dict, seed: int, call: int, device) -> dict:
    """One training batch of step `call`: the grounded_vqa rows, with
    `labels` (the ids; the first `label_mask_share` of each row's tokens
    and the padding set to -100) and one random binary ground-truth mask
    per row at the SAM frame, `gt` [B, 1, S', S'] f32."""
    b = grounded_vqa(dict(mix, kind="grounded_vqa"), model, seed, call,
                     device)
    labels = b["ids"].clone()
    for r, n in enumerate(b["lens"]):
        labels[r, :int(n * mix["label_mask_share"])] = -100
        labels[r, n:] = -100
    gen = torch.Generator(device=device)
    gen.manual_seed(key_of(seed, "traffic/masks", call))
    ss = model["medplib"]["sam"]["image_size"]
    gt = (torch.rand((len(b["lens"]), 1, ss, ss), generator=gen,
                     device=device) > 0.5).float()
    b.update(labels=labels, gt=gt)
    return b


GENERATORS = {"grounded_vqa": grounded_vqa, "seg_sft": seg_sft}


def make(mix: dict, model: dict, seed: int, call: int, device) -> dict:
    return GENERATORS[mix["kind"]](mix, model, seed, call, device)
