"""Multi-task hybrid segmentation / VQA training data
(medplib_tpu/data/hybrid.py): semantic segmentation, referring-expression
segmentation, reasoning segmentation and plain VQA sources, mixed by rate,
each emitting samples in the collator contract of data/dataset.py
(input_ids / labels / image_sam / image_clip / gt_masks / ...).

As in the JAX package: rate-based mixing draws from a random.Random seeded
by (cfg.seed, index), so a sample is a pure function of its index and
resume reproduces it; COCO-style RLE and polygon masks decode here in
numpy and OpenCV (cv2, imported where used), labelme polygons the same
way; the question / answer templates keep the LISA structure ({class_name}
slot, <SEG> answers, optional explanatory long answers).
"""

from __future__ import annotations

import copy
import glob
import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.data import tokenize as tk
from medplib_tpu_torch.data.conversation import conv_templates

IGNORE_LABEL = 255

# -- question/answer templates (structure mirrors LISA's SHORT/LONG/ANSWER
# lists; phrasing is ours) ---------------------------------------------------

SHORT_QUESTION_TEMPLATES = [
    "<image>\nPlease segment the {class_name} in this image.",
    "<image>\nCan you point out the {class_name} with a mask?",
    "<image>\nWhere is the {class_name}? Output a segmentation mask.",
    "<image>\nFind the {class_name} and return its mask.",
]

LONG_QUESTION_TEMPLATES = [
    "<image>\n{sent} Answer with a segmentation mask.",
    "<image>\nGiven the description: {sent}, segment the described target.",
]

EXPLANATORY_QUESTION_TEMPLATES = [
    "Please answer the question and output a segmentation mask.",
    "Answer with text and a mask of the relevant region.",
]

ANSWER_TEMPLATES = [
    "<SEG>.",
    "The mask is <SEG>.",
    "Here it is: <SEG>.",
    "Certainly, <SEG>.",
]


# -- geometry helpers ---------------------------------------------------------

def polygons_to_mask(shapes: Sequence[dict], height: int,
                     width: int) -> np.ndarray:
    """Rasterize labelme-style polygon shapes into a uint8 mask.

    Same semantics as the reference's get_mask_from_json
    (data_processing.py:9-60): polygons painted largest-area first so
    smaller ones overwrite; labels containing 'ignore' paint 255; labels
    equal to 'flag' are skipped.
    """
    import cv2

    areas, valid = [], []
    for shape in shapes:
        if str(shape.get("label", "")).lower() == "flag":
            continue
        pts = np.asarray([shape["points"]], np.int32)
        tmp = np.zeros((height, width), np.uint8)
        cv2.fillPoly(tmp, pts, 1)
        cv2.polylines(tmp, pts, True, 1, 1)
        areas.append(int(tmp.sum()))
        valid.append(shape)

    mask = np.zeros((height, width), np.uint8)
    for i in np.argsort(areas)[::-1]:
        shape = valid[i]
        value = IGNORE_LABEL if "ignore" in str(shape["label"]).lower() else 1
        pts = np.asarray([shape["points"]], np.int32)
        cv2.fillPoly(mask, pts, value)
        cv2.polylines(mask, pts, True, value, 1)
    return mask


def decode_rle(rle: dict) -> np.ndarray:
    """Decode an uncompressed COCO RLE ({'counts': [...], 'size': [h, w]})
    into a uint8 [h, w] mask (column-major runs, like pycocotools)."""
    h, w = rle["size"]
    counts = rle["counts"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape((w, h)).T


def segmentation_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO annotation segmentation -> uint8 mask. Accepts polygon lists
    ([[x0,y0,x1,y1,...], ...]) or uncompressed RLE dicts."""
    import cv2

    if isinstance(segmentation, dict):
        return decode_rle(segmentation)
    mask = np.zeros((height, width), np.uint8)
    for poly in segmentation:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [pts.astype(np.int32)], 1)
    return mask


# -- sample assembly ----------------------------------------------------------

@dataclass
class HybridConfig:
    base_image_dir: str
    conv_template: str = "llava_v1"
    sam_image_size: int = 256
    clip_image_size: int = 336
    num_classes_per_sample: int = 3
    samples_per_epoch: int = 500 * 8 * 2 * 10
    explanatory: float = 0.1
    seed: int = 0
    # per-source dataset selections (reference defaults, dataset.py:180-185)
    sem_seg_data: Sequence[str] = ("ade20k",)
    refer_seg_data: Sequence[str] = ("refcoco",)
    vqa_data: str = "llava_instruct_150k.json"
    reason_seg_data: str = "ReasonSeg|train"


class _Source:
    """Base: turns (image path, [(question, answer)], [masks]) into the
    collator-contract sample dict."""

    def __init__(self, cfg: HybridConfig, tokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.conv = conv_templates[cfg.conv_template]

    def _assemble(self, image_rgb: np.ndarray, qa: List[Tuple[str, str]],
                  masks: List[np.ndarray]) -> Dict:
        cfg = self.cfg
        out: Dict = {"answer_type": None}
        out["original_hw"] = image_rgb.shape[:2]
        out["image_sam"], out["resize_hw"] = pp.preprocess_sam(
            image_rgb, cfg.sam_image_size)
        out["image_clip"] = pp.preprocess_clip(image_rgb, cfg.clip_image_size)

        convo = []
        for q, a in qa:
            convo.append({"from": "human", "value": q})
            convo.append({"from": "gpt", "value": a})
        sources = tk.preprocess_multimodal([copy.deepcopy(convo)])
        d = tk.preprocess_v1(sources, self.tokenizer, self.conv,
                             has_image=True)
        out["input_ids"] = d["input_ids"][0]
        out["labels"] = d["labels"][0]
        out["question"] = d["question"]
        out["gt"] = d["gt"]

        frame = []
        for m in masks:
            m = (m == 1).astype(np.float32)  # drop ignore regions from loss
            resized = pp.resize_longest_side(m, cfg.sam_image_size)
            frame.append(pp.center_pad(resized, cfg.sam_image_size, 0)
                         .astype(np.float32))
        out["gt_masks"] = frame
        out["gt_masks_original"] = [m.astype(np.float32) for m in masks]
        out["region_masks"] = []
        return out


class SemSegSource(_Source):
    """Semantic segmentation -> '<SEG>' QA (sem_seg_dataset.py:127-335).

    Layout: {base}/sem_seg/{name}/images/*.jpg|png with a sibling
    labels/*.png uint8 class-id map, plus classes.json = ["wall", ...].
    """

    def __init__(self, cfg: HybridConfig, tokenizer):
        super().__init__(cfg, tokenizer)
        self.subsets = []
        for name in cfg.sem_seg_data:
            root = os.path.join(cfg.base_image_dir, "sem_seg", name)
            with open(os.path.join(root, "classes.json")) as f:
                classes = json.load(f)
            images = sorted(
                glob.glob(os.path.join(root, "images", "*.jpg")) +
                glob.glob(os.path.join(root, "images", "*.png")))
            self.subsets.append((name, root, classes, images))

    def sample(self, rng: random.Random) -> Dict:
        _, root, classes, images = self.subsets[
            rng.randrange(len(self.subsets))]
        path = images[rng.randrange(len(images))]
        rgb = pp.load_image_rgb(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        label = np.asarray(
            pp.load_image_rgb(os.path.join(root, "labels", stem + ".png"))
        )[..., 0]

        ids = [i for i in np.unique(label).tolist()
               if i != IGNORE_LABEL and i < len(classes)]
        if not ids:
            raise ValueError(f"no classes in {path}")
        rng.shuffle(ids)
        ids = ids[: self.cfg.num_classes_per_sample]

        qa, masks = [], []
        for cid in ids:
            name = classes[cid]
            q = rng.choice(SHORT_QUESTION_TEMPLATES).format(class_name=name)
            qa.append((q, rng.choice(ANSWER_TEMPLATES)))
            masks.append((label == cid).astype(np.uint8))
        return self._assemble(rgb, qa, masks)


class ReferSegSource(_Source):
    """Referring-expression segmentation (refer_seg_dataset.py:19-276).

    Layout: {base}/refer_seg/{name}.json holding COCO-style
    {images: [{file_name,id,height,width}], annotations: {ann_id: {segmentation}},
    refs: [{image_id, ann_id, sentences: [{sent}]}]}.
    """

    def __init__(self, cfg: HybridConfig, tokenizer):
        super().__init__(cfg, tokenizer)
        self.subsets = []
        for name in cfg.refer_seg_data:
            with open(os.path.join(cfg.base_image_dir, "refer_seg",
                                   name + ".json")) as f:
                data = json.load(f)
            img2refs: Dict = {}
            for ref in data["refs"]:
                img2refs.setdefault(ref["image_id"], []).append(ref)
            self.subsets.append((name, data, img2refs))

    def sample(self, rng: random.Random) -> Dict:
        _, data, img2refs = self.subsets[rng.randrange(len(self.subsets))]
        info = data["images"][rng.randrange(len(data["images"]))]
        refs = img2refs.get(info["id"], [])
        if not refs:
            raise ValueError(f"image {info['id']} has no refs")
        pairs = [(s["sent"], ref["ann_id"])
                 for ref in refs for s in ref["sentences"]]
        rng.shuffle(pairs)
        pairs = pairs[: self.cfg.num_classes_per_sample]

        path = info["file_name"]
        if not os.path.isabs(path):
            path = os.path.join(self.cfg.base_image_dir, path)
        rgb = pp.load_image_rgb(path)

        qa, masks = [], []
        for sent, ann_id in pairs:
            q = rng.choice(SHORT_QUESTION_TEMPLATES).format(
                class_name=sent.strip().lower())
            qa.append((q, rng.choice(ANSWER_TEMPLATES)))
            ann = data["annotations"][str(ann_id)]
            masks.append(segmentation_to_mask(
                ann["segmentation"], info["height"], info["width"]))
        return self._assemble(rgb, qa, masks)


class ReasonSegSource(_Source):
    """Reasoning segmentation with labelme polygon JSONs
    (reason_seg_dataset.py:21-218): short questions for phrase targets,
    long questions for sentence targets, optional explanatory text answers.

    Layout: {base}/reason_seg/{name}/{split}/*.jpg + sibling .json
    ({shapes: [{label, points}], text, is_sentence}); optional
    explanatory/train.json [{image, query, outputs}].
    """

    def __init__(self, cfg: HybridConfig, tokenizer):
        super().__init__(cfg, tokenizer)
        name, splits = cfg.reason_seg_data.split("|")
        root = os.path.join(cfg.base_image_dir, "reason_seg", name)
        self.images: List[str] = []
        for split in splits.split("_"):
            self.images.extend(
                sorted(glob.glob(os.path.join(root, split, "*.jpg"))))
        self.explanations: Dict[str, dict] = {}
        exp_path = os.path.join(root, "explanatory", "train.json")
        if cfg.explanatory >= 0 and os.path.exists(exp_path):
            with open(exp_path) as f:
                for item in json.load(f):
                    self.explanations[item["image"]] = item

    def sample(self, rng: random.Random) -> Dict:
        path = self.images[rng.randrange(len(self.images))]
        rgb = pp.load_image_rgb(path)
        with open(os.path.splitext(path)[0] + ".json") as f:
            anno = json.load(f)
        mask = polygons_to_mask(anno["shapes"], *rgb.shape[:2])
        text, is_sentence = anno["text"], anno.get("is_sentence", False)

        if is_sentence:
            q = rng.choice(LONG_QUESTION_TEMPLATES).format(sent=text)
        else:
            q = rng.choice(SHORT_QUESTION_TEMPLATES).format(
                class_name=text.strip().lower())
        a = rng.choice(ANSWER_TEMPLATES)

        exp = self.explanations.get(os.path.basename(path))
        if exp is not None and rng.random() < self.cfg.explanatory:
            q = q + " " + rng.choice(EXPLANATORY_QUESTION_TEMPLATES)
            a = f"{exp['outputs']} <SEG>."
        return self._assemble(rgb, [(q, a)], [mask])


class VqaSource(_Source):
    """Plain LLaVA-instruct VQA, no masks (vqa_dataset.py:31-135).
    Layout: {base}/vqa/{vqa_data} = [{image, conversations}]; images under
    {base}/vqa/images/."""

    def __init__(self, cfg: HybridConfig, tokenizer):
        super().__init__(cfg, tokenizer)
        with open(os.path.join(cfg.base_image_dir, "vqa", cfg.vqa_data)) as f:
            self.records = json.load(f)

    def sample(self, rng: random.Random) -> Dict:
        item = self.records[rng.randrange(len(self.records))]
        path = os.path.join(self.cfg.base_image_dir, "vqa", "images",
                            item["image"])
        rgb = pp.load_image_rgb(path)
        convo = item["conversations"]
        if convo and convo[0]["from"] != "human":
            convo = convo[1:]
        qa = [(convo[i]["value"], convo[i + 1]["value"])
              for i in range(0, len(convo) - 1, 2)]
        return self._assemble(rgb, qa, [])


_SOURCE_TYPES = {
    "sem_seg": SemSegSource,
    "refer_seg": ReferSegSource,
    "vqa": VqaSource,
    "reason_seg": ReasonSegSource,
}


class HybridDataset:
    """Rate-weighted mixture over task sources (dataset.py:163-270).

    Map-style with `samples_per_epoch` virtual length; index seeds the
    draw so shuffle/resume are reproducible (the reference uses global
    np.random and ignores idx entirely)."""

    def __init__(self, cfg: HybridConfig, tokenizer,
                 datasets: str = "sem_seg||refer_seg||vqa||reason_seg",
                 sample_rates: Sequence[float] = (9, 3, 3, 1)):
        names = datasets.split("||")
        if len(sample_rates) != len(names):
            raise ValueError("sample_rates must match datasets")
        self.cfg = cfg
        self.sources = [_SOURCE_TYPES[n](cfg, tokenizer) for n in names]
        rates = np.asarray(sample_rates, np.float64)
        self.rates = rates / rates.sum()

    def __len__(self):
        return self.cfg.samples_per_epoch

    def __getitem__(self, idx: int) -> Dict:
        rng = random.Random(self.cfg.seed * 1_000_003 + idx)
        r, acc = rng.random(), 0.0
        src = self.sources[-1]
        for source, rate in zip(self.sources, self.rates):
            acc += rate
            if r < acc:
                src = source
                break
        for attempt in range(8):  # skip degenerate draws (empty refs etc.)
            try:
                return src.sample(rng)
            except (ValueError, FileNotFoundError):
                continue
        raise RuntimeError("hybrid source failed 8 consecutive draws")
