"""Released-checkpoint loading (the loader half of
medplib_tpu/utils/export.py): a merged MedPLIB HF export directory (LLM +
projector + text_hidden_fcs + region adapter + a SAM copy), optionally the
standalone SAM-Med2D checkpoint and a CLIP HF directory -> the port's param
tree, through utils/hf_weights. No JAX, no download: `*.bin` shards are read
with torch.load(weights_only=True), `*.safetensors` shards only where the
`safetensors` package is installed.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

from medplib_tpu_torch.utils import hf_weights as hw


def load_hf_torch_dir(path: str, device="cuda") -> dict:
    """Read a merged HF export directory's *.bin (or, without any,
    *.safetensors) shards into one state dict of tensors on `device`, in
    their stored dtypes."""
    bins = sorted(glob.glob(os.path.join(path, "*.bin")))
    if bins:
        import torch
        sd = {}
        for f in bins:
            sd.update(torch.load(f, map_location=device, weights_only=True))
        return sd
    sts = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if sts:
        try:
            from safetensors import safe_open
        except ImportError as e:
            raise ImportError(
                f"{path} holds *.safetensors shards; reading them needs the "
                f"'safetensors' package, which is not installed") from e
        sd = {}
        for f in sts:
            with safe_open(f, framework="pt", device=str(device)) as h:
                for k in h.keys():
                    sd[k] = h.get_tensor(k)
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
