"""Checkpoint export and conversion tools (medplib_tpu/utils/export.py):

- merge_lora: fold LoRA adapters into their kernels;
- cast_f32: cast a tree's floating-point leaves to float32;
- inspect_tree: one line per leaf (path, shape, dtype, size) and a TOTAL;
- make_delta / apply_delta: a fine-tuned tree as a delta on a base tree;
- consolidate: a checkpoint file loaded and written again as one file;
- export_seg_decoder: the <SEG> -> mask head as a serialized torch.export
  program (the JAX package's StableHLO artifact);
- load_hf_torch_dir / load_reference_checkpoint: a merged MedPLIB HF
  export directory (LLM + projector + text_hidden_fcs + region adapter + a
  SAM copy), optionally the standalone SAM-Med2D checkpoint and a CLIP HF
  directory -> the port's param tree, through utils/hf_weights. `*.bin`
  shards are read with torch.load(weights_only=True), `*.safetensors`
  shards with the port's own reader (utils/_safetensors);
- main: the command line, `python -m medplib_tpu_torch.utils.export
  {merge-lora, to-f32, inspect, from-reference, to-hf} ...`.
"""

from __future__ import annotations

import glob
import io
import os
from typing import Any, Optional, Sequence

import torch

from medplib_tpu_torch.utils import _safetensors
from medplib_tpu_torch.utils import hf_weights as hw


def merge_lora(params: Any, scale: float = 2.0) -> Any:
    from medplib_tpu_torch.train.lora import merge
    return merge(params, scale=scale)


def cast_f32(params: Any) -> Any:
    return hw.cast_tree(params, torch.float32)


def inspect_tree(params: Any, out=print) -> int:
    """Print each leaf (dict keys sorted, as the JAX package flattens) as
    `path shape dtype size`, then the TOTAL; -> the total size."""
    from medplib_tpu_torch.utils.tree import leaves_with_paths
    total = 0
    for path, leaf in leaves_with_paths(params):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        n = 1
        for d in shape:
            n *= d
        total += n
        dtype = (str(leaf.dtype).replace("torch.", "")
                 if hasattr(leaf, "dtype") else "?")
        out(f"{'/'.join(path):80s} {str(shape):20s} {dtype} {n:>12,d}")
    out(f"{'TOTAL':80s} {'':20s} {'':8s} {total:>12,d}")
    return total


def load_hf_torch_dir(path: str, device="cuda") -> dict:
    """Read a merged HF export directory's *.bin (or, without any,
    *.safetensors) shards into one state dict of tensors on `device`, in
    their stored dtypes."""
    bins = sorted(glob.glob(os.path.join(path, "*.bin")))
    if bins:
        sd = {}
        for f in bins:
            sd.update(torch.load(f, map_location=device, weights_only=True))
        return sd
    sts = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if sts:
        sd = {}
        for f in sts:
            sd.update(_safetensors.load_file(f, device))
        return sd
    raise FileNotFoundError(f"no *.bin or *.safetensors under {path}")


def load_reference_checkpoint(hf_dir: Optional[str] = None,
                              sam_path: Optional[str] = None,
                              clip_dir: Optional[str] = None,
                              moe: bool = True, num_experts: int = 2,
                              cfg=None, state_dict: Optional[dict] = None,
                              device="cuda"):
    """-> (cfg, params). The merged export stores everything under
    `model.` (lm_head.weight at the top); SAM comes from `sam_path` when
    given, else from the copy under model.visual_model.*; CLIP only from
    `clip_dir`. Pass `state_dict` instead of `hf_dir` to translate one
    already in memory (its tensors keep their device). Without `cfg` the
    config is the released MedPLIB-7b-2e (2 experts, top-1, dense MoE).

    The tree holds the leaves the checkpoints carry: no CLIP without
    `clip_dir`, and never the ICL compressor, mask encoder or geo sampler;
    merge it over an initialized tree for those."""
    from medplib_tpu_torch.config import MedplibConfig, MoeConfig

    if state_dict is None:
        if hf_dir is None:
            raise ValueError("give hf_dir or state_dict")
        state_dict = load_hf_torch_dir(hf_dir, device)
    sd = state_dict
    if cfg is None:
        cfg = MedplibConfig(
            moe=MoeConfig(enable=moe, num_experts=num_experts, top_k=1,
                          capacity_factor=1.5, eval_capacity_factor=2.0,
                          moe_mode="dense"))
    else:
        moe, num_experts = cfg.moe.enable, cfg.moe.num_experts

    if moe:
        llm = hw.moe_llama_from_hf(
            sd, cfg.llm, cfg.moe.layer_indices(cfg.llm.num_layers),
            num_experts)
    else:
        llm = hw.llama_from_hf(sd, cfg.llm)
    params = {"llm": llm}

    # nn.Sequential(Linear, GELU, Linear): model.mm_projector.{0,2}.*
    params["mm_projector"] = {"layers": [
        hw._linear(sd, f"model.mm_projector.{i}") for i in (0, 2)
        if f"model.mm_projector.{i}.weight" in sd]}
    if "model.region_fea_adapter.weight" in sd:
        params["region_fea_adapter"] = hw._linear(sd,
                                                  "model.region_fea_adapter")
    # Sequential(Linear, ReLU, Linear, Dropout): model.text_hidden_fcs.0.{0,2}
    if "model.text_hidden_fcs.0.0.weight" in sd:
        params["text_hidden_fcs"] = {
            "fc1": hw._linear(sd, "model.text_hidden_fcs.0.0"),
            "fc2": hw._linear(sd, "model.text_hidden_fcs.0.2")}

    if sam_path is not None:
        import torch
        params["sam"] = hw.sam_from_torch(
            torch.load(sam_path, map_location=device, weights_only=True),
            cfg.sam)
    else:
        pre = "model.visual_model."
        vis = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        if vis:
            params["sam"] = hw.sam_from_torch(vis, cfg.sam)

    if clip_dir is not None:
        params["clip"] = hw.clip_vision_from_hf(
            load_hf_torch_dir(clip_dir, device), cfg.vision)
    return cfg, params


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def make_delta(base: Any, target: Any) -> Any:
    """target - base for each leaf both trees hold at one shape, computed
    in float32 and cast back to the target leaf's dtype; target-only
    leaves (e.g. the projector) and leaves of another shape (resized
    vocabulary rows) pass through."""
    def rec(t, b):
        if isinstance(t, dict):
            return {k: (rec(v, b[k]) if isinstance(b, dict) and k in b else v)
                    for k, v in t.items()}
        if b is None or not _is_tensor(t) or not _is_tensor(b) \
                or tuple(b.shape) != tuple(t.shape):
            return t
        return (t.float() - b.to(t.device).float()).to(t.dtype)

    return rec(target, base)


def apply_delta(base: Any, delta: Any) -> Any:
    """base + delta, in float32 and cast back to the delta leaf's dtype;
    delta-only leaves and leaves of another shape pass through."""
    def rec(d, b):
        if isinstance(d, dict):
            return {k: (rec(v, b[k]) if isinstance(b, dict) and k in b else v)
                    for k, v in d.items()}
        if b is None or not _is_tensor(d) or not _is_tensor(b) \
                or tuple(b.shape) != tuple(d.shape):
            return d
        return (b.to(d.device).float() + d.float()).to(d.dtype)

    return rec(delta, base)


def consolidate(src_path: str, dst_path: str, device="cuda") -> None:
    """Load a params file and write it again as one self-contained file
    (views saved in it become their own storage)."""
    from medplib_tpu_torch.utils.checkpoint import load_params, save_params
    save_params(dst_path, load_params(src_path, device=device))


class _SegDecoder(torch.nn.Module):
    """(sam params, text_hidden_fcs params, SAM image embeddings
    [B, e, e, D], hidden states of the <SEG> tokens [B, S, hidden]) ->
    (mask logits [B, S, size, size], iou [B, S])."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def forward(self, sam_params, text_params, sam_emb, hidden):
        from medplib_tpu_torch.models import medplib
        seg = medplib.text_hidden_fcs(text_params, hidden)
        full = {"sam": sam_params, "text_hidden_fcs": text_params}
        return medplib.decode_seg_masks(full, self.cfg, sam_emb, seg,
                                        self.cfg.sam.image_size)


def export_seg_decoder(params: Any, cfg, batch_size: int = 1,
                       num_segs: int = 1) -> bytes:
    """The <SEG> -> mask decode head as a serialized torch.export program:
    text_hidden_fcs, then decode_seg_masks, on fixed shapes. The program
    takes (params["sam"], params["text_hidden_fcs"], SAM image embeddings
    [batch_size, e, e, prompt_embed_dim], <SEG> hidden states
    [batch_size, num_segs, hidden]) in the dtype of text_hidden_fcs and on
    the device of its leaves, and returns (mask logits, iou). Run it with
    `torch.export.load(io.BytesIO(blob)).module()(*args)`."""
    sub_sam, sub_txt = params["sam"], params["text_hidden_fcs"]
    k = sub_txt["fc1"]["kernel"]
    e, d = cfg.sam.image_embedding_size, cfg.sam.prompt_embed_dim
    emb = torch.zeros((batch_size, e, e, d), dtype=k.dtype, device=k.device)
    hid = torch.zeros((batch_size, num_segs, cfg.llm.hidden_size),
                      dtype=k.dtype, device=k.device)
    with torch.no_grad():
        ep = torch.export.export(_SegDecoder(cfg),
                                 (sub_sam, sub_txt, emb, hid))
    ep.example_inputs = None     # else the blob carries the weights too
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    from medplib_tpu_torch.config import from_json, to_json
    from medplib_tpu_torch.utils.checkpoint import load_params, save_params

    ap = argparse.ArgumentParser(description="checkpoint tools")
    ap.add_argument("--device", default="cuda",
                    help="where trees are loaded and computed (cuda, cpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("merge-lora")
    m.add_argument("--in-path", required=True)
    m.add_argument("--out-path", required=True)
    c = sub.add_parser("to-f32")
    c.add_argument("--in-path", required=True)
    c.add_argument("--out-path", required=True)
    i = sub.add_parser("inspect")
    i.add_argument("--in-path", required=True)
    t = sub.add_parser("from-reference")
    t.add_argument("--hf-dir", required=True)
    t.add_argument("--sam-path")
    t.add_argument("--clip-dir")
    t.add_argument("--dense", action="store_true")
    t.add_argument("--config", default=None,
                   help="config json steering the translation (dims, MoE "
                        "layout); default is the MedPLIB-7b-2e config")
    t.add_argument("--out-path", required=True)
    h = sub.add_parser(
        "to-hf", help="re-export a tree as a merged HF safetensors dir "
        "(inverse of from-reference; the reference merge tools' layout)")
    h.add_argument("--in-path", required=True)
    h.add_argument("--config", required=True,
                   help="config json (written by from-reference / train)")
    h.add_argument("--out-dir", required=True)
    h.add_argument("--shard-bytes", type=int, default=4 * 1024 ** 3)
    args = ap.parse_args(argv)

    dev = args.device
    if args.cmd == "merge-lora":
        save_params(args.out_path,
                    merge_lora(load_params(args.in_path, device=dev)))
    elif args.cmd == "to-f32":
        save_params(args.out_path,
                    cast_f32(load_params(args.in_path, device=dev)))
    elif args.cmd == "inspect":
        inspect_tree(load_params(args.in_path, device=dev))
    elif args.cmd == "from-reference":
        user_cfg = None
        if args.config:
            with open(args.config) as f:
                user_cfg = from_json(f.read())
        cfg, params = load_reference_checkpoint(
            args.hf_dir, args.sam_path, args.clip_dir, moe=not args.dense,
            cfg=user_cfg, device=dev)
        save_params(args.out_path, params)
        with open(args.out_path + ".config.json", "w") as f:
            f.write(to_json(cfg))
    elif args.cmd == "to-hf":
        from medplib_tpu_torch.utils.hf_export import (medplib_to_hf,
                                                       save_hf_dir)
        with open(args.config) as f:
            text = f.read()
        sd = medplib_to_hf(load_params(args.in_path, device=dev),
                           from_json(text))
        save_hf_dir(sd, args.out_dir, config_json=text,
                    shard_bytes=args.shard_bytes)


if __name__ == "__main__":
    main()
