"""Image retrieval (medplib_tpu/rag/image_rag.py): a CLIP-embedding index
over candidate (image, mask) pairs, whose top-k neighbours become a test
record's in-context examples.

An embedding is the L2-normalized mean of the CLIP patch tokens (f32);
`build_index` writes embeddings.npy + metadata.json, `augment` attaches
the top-k cosine neighbours as `icl_examples`. The index format is the
JAX package's, so an index built by either package is read by the other.

  python -m medplib_tpu_torch.rag.image_rag build --candidates c.json \\
    --image-folder images --out-dir index [--clip-checkpoint F] [--device cpu]
  python -m medplib_tpu_torch.rag.image_rag augment --test-json t.json \\
    --index-dir index --out-json t_aug.json --top-k 2 [--device cpu]

Encoders load through medplib_tpu_torch.utils.checkpoint.load_params: one
torch.save file of a CLIP vision tree (save_params), not an orbax
directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from medplib_tpu_torch.config import ClipVisionConfig
from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.models import clip


# Encoder registry: four retrieval encoder types (general CLIP, medical,
# detection and mask-aware fine-tunes), all CLIP-vision-family weights;
# the type selects the default checkpoint under MEDPLIB_RAG_ENCODER_ROOT
# unless an explicit path is given.
RAG_ENCODER_DEFAULT_PATHS = {
    "clip_encoder": "clip-vit-large-patch14-336",
    "med_encoder": "med_encoder",
    "det_encoder": "det_encoder",
    "mask_encoder": "mask_encoder",
}


def make_encoder(encoder_type: str = "clip_encoder",
                 encoder_path: Optional[str] = None,
                 cfg: Optional[ClipVisionConfig] = None,
                 batch_size: int = 16, device="cuda") -> "ImageRagEncoder":
    """Resolve an encoder type to a loaded ImageRagEncoder on `device`."""
    if encoder_type not in RAG_ENCODER_DEFAULT_PATHS:
        known = ", ".join(sorted(RAG_ENCODER_DEFAULT_PATHS))
        raise ValueError(f"unknown RAG encoder type {encoder_type!r} "
                         f"(known: {known})")
    if not encoder_path:
        root = os.environ.get("MEDPLIB_RAG_ENCODER_ROOT", "checkpoints")
        encoder_path = os.path.join(
            root, RAG_ENCODER_DEFAULT_PATHS[encoder_type])
    from medplib_tpu_torch.utils.checkpoint import load_params
    params = load_params(encoder_path, device=device)
    return ImageRagEncoder(params, cfg or ClipVisionConfig(),
                           batch_size=batch_size, encoder_type=encoder_type)


class ImageRagEncoder:
    """CLIP-family vision encoder -> one embedding per image, on the
    device of its parameters."""

    def __init__(self, clip_params, cfg: ClipVisionConfig,
                 batch_size: int = 16,
                 encoder_type: str = "clip_encoder"):
        self.params = clip_params
        self.cfg = cfg
        self.batch_size = batch_size
        self.encoder_type = encoder_type
        self.device = clip_params["embeddings"]["patch_embedding"][
            "kernel"].device

    @torch.no_grad()
    def embed_batch(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] CLIP pixels -> [B, hidden] unit f32 embeddings."""
        feats = clip.forward_features(self.params, pixels, self.cfg)
        emb = feats.float().mean(dim=1)   # mean of the patch tokens
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def encode_paths(self, paths: Sequence[str]) -> np.ndarray:
        out = []
        size = self.cfg.image_size
        for start in range(0, len(paths), self.batch_size):
            chunk = paths[start:start + self.batch_size]
            pixels = np.stack([
                pp.preprocess_clip(pp.load_image_rgb(p), size)
                for p in chunk])
            emb = self.embed_batch(torch.from_numpy(pixels).to(self.device))
            out.append(emb.cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 1))


# The JSON record schema of the ICL data files: the query image is "image"
# or the highest-numbered "imageN"; the target mask is the first non-null
# of the keys below or an inline <mask> tag; candidate pairs come from
# icl_examples / examples lists or imageN / maskN.
_MASK_KEY_PRIORITY = ("target_mask", "mask", "mask3")
_MASK_TAG = None  # compiled lazily to keep `import re` local


def _numbered(item: Dict, prefix: str) -> List[int]:
    """Sorted N over every `<prefix>N` key present in the record."""
    return sorted(int(k[len(prefix):]) for k in item
                  if k.startswith(prefix) and k[len(prefix):].isdigit())


def extract_target_mask(item: Dict) -> Optional[str]:
    global _MASK_TAG
    direct = next((item[k] for k in _MASK_KEY_PRIORITY
                   if item.get(k) is not None), None)
    if direct is not None:
        return direct
    if _MASK_TAG is None:
        import re
        _MASK_TAG = re.compile(r"<mask>(.*?)</mask>", re.S)
    for turn in item.get("conversations", []):
        hit = _MASK_TAG.search(str(turn.get("value", "")))
        if hit:
            return hit.group(1)
    return None


def extract_query_image(item: Dict) -> Optional[str]:
    if item.get("image") is not None:
        return item["image"]
    ns = _numbered(item, "image")
    return item[f"image{ns[-1]}"] if ns else None


def _record_pairs(rec: Dict):
    """Yield every (image, mask) pair reachable from one record: the query
    pair, the icl_examples / examples list, and paired imageN / maskN."""
    img, msk = extract_query_image(rec), extract_target_mask(rec)
    if img is not None and msk is not None:
        yield img, msk
    for ex in rec.get("icl_examples", rec.get("examples", [])):
        if ex.get("image") is not None and ex.get("mask") is not None:
            yield ex["image"], ex["mask"]
    for n in _numbered(rec, "image"):
        img, msk = rec.get(f"image{n}"), rec.get(f"mask{n}")
        if img is not None and msk is not None:
            yield img, msk


def collect_candidates(candidate_json: str, image_folder: str) -> List[Dict]:
    with open(candidate_json) as f:
        records = json.load(f)

    def resolve(path):
        if os.path.isabs(path) or os.path.exists(path):
            return path
        return os.path.join(image_folder, path)

    return [{"image": resolve(img), "mask": msk, "record": rec}
            for rec in records for img, msk in _record_pairs(rec)]


def build_index(candidate_json: str, image_folder: str, out_dir: str,
                encoder: ImageRagEncoder) -> Dict:
    cands = collect_candidates(candidate_json, image_folder)
    emb = encoder.encode_paths([c["image"] for c in cands])
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "embeddings.npy"), emb)
    meta = [{"image": c["image"], "mask": c["mask"]} for c in cands]
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return {"count": len(cands), "dim": int(emb.shape[-1] if len(emb) else 0)}


def augment(test_json: str, index_dir: str, out_json: str,
            encoder: ImageRagEncoder, top_k: int = 1,
            image_folder: str = "") -> int:
    """Attach `icl_examples` (the top-k cosine neighbours) to every test
    record."""
    emb = np.load(os.path.join(index_dir, "embeddings.npy"))
    with open(os.path.join(index_dir, "metadata.json")) as f:
        meta = json.load(f)
    with open(test_json) as f:
        tests = json.load(f)

    paths = []
    for rec in tests:
        p = rec["image"]
        if not os.path.isabs(p):
            p = os.path.join(image_folder, p)
        paths.append(p)
    queries = encoder.encode_paths(paths)
    sims = queries @ emb.T  # cosine (both normalized)
    order = np.argsort(-sims, axis=1)[:, :top_k]
    for rec, idxs in zip(tests, order):
        rec["icl_examples"] = [
            {"image": meta[i]["image"], "mask": meta[i]["mask"]}
            for i in idxs]
    with open(out_json, "w") as f:
        json.dump(tests, f)
    return len(tests)


def build_argparser():
    import argparse
    ap = argparse.ArgumentParser(description="image-RAG index build/augment")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("--candidates", required=True)
    b.add_argument("--image-folder", default="")
    b.add_argument("--out-dir", required=True)
    b.add_argument("--encoder-type", default="clip_encoder",
                   choices=sorted(RAG_ENCODER_DEFAULT_PATHS))
    b.add_argument("--clip-checkpoint", default=None,
                   help="explicit save_params file (one torch.save tree, "
                   "not an orbax directory); else the encoder type's "
                   "default path under MEDPLIB_RAG_ENCODER_ROOT")
    a = sub.add_parser("augment")
    a.add_argument("--test-json", required=True)
    a.add_argument("--index-dir", required=True)
    a.add_argument("--out-json", required=True)
    a.add_argument("--image-folder", default="")
    a.add_argument("--top-k", type=int, default=1)
    a.add_argument("--encoder-type", default="clip_encoder",
                   choices=sorted(RAG_ENCODER_DEFAULT_PATHS))
    a.add_argument("--clip-checkpoint", default=None)
    for p in (b, a):
        p.add_argument("--device", default="cuda",
                       help="torch device of the encoder (cuda, cpu)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    enc = make_encoder(args.encoder_type, args.clip_checkpoint,
                       device=args.device)
    if args.cmd == "build":
        print(build_index(args.candidates, args.image_folder, args.out_dir,
                          enc))
    else:
        n = augment(args.test_json, args.index_dir, args.out_json, enc,
                    args.top_k, args.image_folder)
        print(f"augmented {n} records -> {args.out_json}")


if __name__ == "__main__":
    main()
