"""Inverse weight translation: the port's param trees -> HF / torch state
dicts in the layout the reference's merge tools write
(medplib_tpu/utils/hf_export.py), so that `hf_weights` reads them back
leaf for leaf: DeepSpeed MoE expert naming, the Residual-MoE dense copy
(`mlp.mlp.*` + `coefficient.*`) and the SAM copy under
`model.visual_model.*`.

Values are views of the tree's tensors wherever the layout allows (a
transpose, a layer of a stack), so a state dict of a 7B tree costs no
second copy. save_hf_dir writes a dict as an HF directory of safetensors
shards (utils/_safetensors, no `safetensors` package), one tensor at a
time through host memory.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Mapping, Optional

import torch

from medplib_tpu_torch.config import LlamaConfig, MedplibConfig, SamConfig
from medplib_tpu_torch.utils import _safetensors

StateDict = Dict[str, torch.Tensor]


def _oihw(k: torch.Tensor) -> torch.Tensor:
    """HWIO -> torch's [out, in, kh, kw]."""
    return k.permute(3, 2, 0, 1)


# ---------------------------------------------------------------------------
# LLaMA (inverse of hf_weights.llama_from_hf)
# ---------------------------------------------------------------------------

def llama_to_hf(params: Mapping[str, Any], cfg: LlamaConfig,
                prefix: str = "model.") -> StateDict:
    """init_llama()-shaped tree -> HF LlamaForCausalLM state dict. q/k/v
    are stored [out, in] and export as they are; o_proj and the MLP
    transpose back. A dense MLP stored with M zero-padded is sliced back
    to the architecture's M."""
    sd: StateDict = {
        prefix + "embed_tokens.weight": params["embed_tokens"]["embedding"],
        prefix + "norm.weight": params["norm"]["weight"],
        "lm_head.weight": params["lm_head"]["kernel"].t(),
    }
    layers = params["layers"]
    attn = layers["attn"]
    m = cfg.intermediate_size
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = \
            layers["input_layernorm"]["weight"][i]
        sd[p + "post_attention_layernorm.weight"] = \
            layers["post_attention_layernorm"]["weight"][i]
        for n in ("q_proj", "k_proj", "v_proj"):
            sd[p + f"self_attn.{n}.weight"] = attn[n]["kernel"][i]
        sd[p + "self_attn.o_proj.weight"] = attn["o_proj"]["kernel"][i].t()
        if "mlp" in layers:     # absent once strip_dense_mlp dropped it
            for n in ("gate_proj", "up_proj", "down_proj"):
                w = layers["mlp"][n]["kernel"][i]
                w = w[:, :m] if n != "down_proj" else w[:m, :]
                sd[p + f"mlp.{n}.weight"] = w.t()
    return sd


def moe_llama_to_hf(params: Mapping[str, Any], cfg: LlamaConfig,
                    moe_layer_indices: Iterable[int], num_experts: int,
                    prefix: str = "model.") -> StateDict:
    """moe_llama tree -> merged-HF state dict with DeepSpeed MoE naming.
    MoE layers emit `mlp.deepspeed_moe.gate.wg.weight` and per-expert
    `experts.deepspeed_experts.{e}.{gate,up,down}_proj.weight` and no dense
    MLP keys; Residual-MoE trees also emit `mlp.mlp.*` and
    `mlp.coefficient.*`. Experts padded to M % 1024 == 0 slice back."""
    moe_set = set(moe_layer_indices)
    sd = llama_to_hf(params, cfg, prefix)
    moe_p = params["layers"]["moe"]
    routers = moe_p["router"]["kernel"]
    m = cfg.intermediate_size
    ek = {n: moe_p["experts"][n]["kernel"]
          for n in ("gate_proj", "up_proj", "down_proj")}
    ek["gate_proj"] = ek["gate_proj"][..., :m]
    ek["up_proj"] = ek["up_proj"][..., :m]
    ek["down_proj"] = ek["down_proj"][..., :m, :]
    res, coef = moe_p.get("residual_mlp"), moe_p.get("coefficient")
    for i in sorted(moe_set):
        p = f"{prefix}layers.{i}.mlp."
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd.pop(p + f"{n}.weight", None)
        sd[p + "deepspeed_moe.gate.wg.weight"] = routers[i].t()
        for n in ("gate_proj", "up_proj", "down_proj"):
            for e in range(num_experts):
                sd[p + "deepspeed_moe.experts.deepspeed_experts."
                   f"{e}.{n}.weight"] = ek[n][i, e].t()
        if res is not None:
            for n in ("gate_proj", "up_proj", "down_proj"):
                sd[p + f"mlp.{n}.weight"] = res[n]["kernel"][i].t()
            sd[p + "coefficient.weight"] = coef["kernel"][i].t()
            sd[p + "coefficient.bias"] = coef["bias"][i]
    return sd


# ---------------------------------------------------------------------------
# SAM-Med2D (inverse of hf_weights.sam_from_torch)
# ---------------------------------------------------------------------------

def sam_to_torch(params: Mapping[str, Any], cfg: SamConfig,
                 prefix: str = "") -> StateDict:
    """SAM tree -> the sam-med2d torch key space. Rel-pos tables, stored
    padded to the longest, are trimmed back to each block's 2 size - 1
    rows (window blocks: the window, global blocks: the feature grid)."""
    sd: StateDict = {}
    enc = params["image_encoder"]
    p = prefix + "image_encoder."
    sd[p + "patch_embed.proj.weight"] = _oihw(enc["patch_embed"]["kernel"])
    sd[p + "patch_embed.proj.bias"] = enc["patch_embed"]["bias"]
    sd[p + "pos_embed"] = enc["pos_embed"]
    grid = cfg.image_embedding_size
    blocks = enc["blocks"]
    attn = blocks["attn"]
    for i in range(cfg.encoder_depth):
        b = p + f"blocks.{i}."
        size = grid if i in cfg.encoder_global_attn_indexes \
            else cfg.window_size
        rel_len = 2 * size - 1
        for n in ("norm1", "norm2"):
            sd[b + n + ".weight"] = blocks[n]["weight"][i]
            sd[b + n + ".bias"] = blocks[n]["bias"][i]
        for n in ("qkv", "proj"):
            sd[b + f"attn.{n}.weight"] = attn[n]["kernel"][i].t()
            sd[b + f"attn.{n}.bias"] = attn[n]["bias"][i]
        sd[b + "attn.rel_pos_h"] = attn["rel_pos_h"][i, :rel_len]
        sd[b + "attn.rel_pos_w"] = attn["rel_pos_w"][i, :rel_len]
        for n in ("lin1", "lin2"):
            sd[b + f"mlp.{n}.weight"] = blocks["mlp"][n]["kernel"][i].t()
            sd[b + f"mlp.{n}.bias"] = blocks["mlp"][n]["bias"][i]
        if cfg.use_adapter:
            ad = blocks["adapter"]
            sd[b + "Adapter.channel.0.weight"] = \
                ad["channel_fc1"]["kernel"][i].t()
            sd[b + "Adapter.channel.2.weight"] = \
                ad["channel_fc2"]["kernel"][i].t()
            sd[b + "Adapter.spatial.0.weight"] = _oihw(
                ad["spatial_conv"]["kernel"][i])
            sd[b + "Adapter.spatial.2.weight"] = \
                ad["spatial_convt"]["kernel"][i]
            sd[b + "Adapter.norm.weight"] = ad["norm"]["weight"][i]
            sd[b + "Adapter.norm.bias"] = ad["norm"]["bias"][i]
    neck = enc["neck"]
    for j, (cv, ln) in enumerate((("conv1", "ln1"), ("conv2", "ln2"))):
        sd[p + f"neck.{2 * j}.weight"] = _oihw(neck[cv]["kernel"])
        sd[p + f"neck.{2 * j + 1}.weight"] = neck[ln]["weight"]
        sd[p + f"neck.{2 * j + 1}.bias"] = neck[ln]["bias"]

    pe = params["prompt_encoder"]
    q = prefix + "prompt_encoder."
    sd[q + "pe_layer.positional_encoding_gaussian_matrix"] = \
        pe["pe_layer"]["gaussian_matrix"]
    for i in range(4):
        sd[q + f"point_embeddings.{i}.weight"] = \
            pe["point_embeddings"][i][None]
    sd[q + "not_a_point_embed.weight"] = pe["not_a_point_embed"][None]
    sd[q + "no_mask_embed.weight"] = pe["no_mask_embed"][None]
    for name, j in (("conv1", 0), ("ln1", 1), ("conv2", 3), ("ln2", 4),
                    ("conv3", 6)):
        leaf = pe["mask_downscaling"][name]
        sd[q + f"mask_downscaling.{j}.weight"] = (
            _oihw(leaf["kernel"]) if name.startswith("conv")
            else leaf["weight"])
        sd[q + f"mask_downscaling.{j}.bias"] = leaf["bias"]

    md = params["mask_decoder"]
    r = prefix + "mask_decoder."

    def put_lin(name, leaf):
        sd[r + name + ".weight"] = leaf["kernel"].t()
        if "bias" in leaf:
            sd[r + name + ".bias"] = leaf["bias"]

    def put_ln(name, leaf):
        sd[r + name + ".weight"] = leaf["weight"]
        sd[r + name + ".bias"] = leaf["bias"]

    def put_attn(name, blk):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put_lin(name + "." + n, blk[n])

    sd[r + "iou_token.weight"] = md["iou_token"]
    sd[r + "mask_tokens.weight"] = md["mask_tokens"]
    for i, layer in enumerate(md["transformer"]["layers"]):
        b = f"transformer.layers.{i}"
        for n in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            put_attn(f"{b}.{n}", layer[n])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            put_ln(f"{b}.{n}", layer[n])
        put_lin(b + ".mlp.lin1", layer["mlp"]["lin1"])
        put_lin(b + ".mlp.lin2", layer["mlp"]["lin2"])
    put_attn("transformer.final_attn_token_to_image",
             md["transformer"]["final_attn_token_to_image"])
    put_ln("transformer.norm_final_attn", md["transformer"]["norm_final_attn"])
    up = md["output_upscaling"]
    for name, j in (("convt1", 0), ("convt2", 3)):   # torch layout already
        sd[r + f"output_upscaling.{j}.weight"] = up[name]["kernel"]
        sd[r + f"output_upscaling.{j}.bias"] = up[name]["bias"]
    put_ln("output_upscaling.1", up["ln"])
    for mi, mlp in enumerate(md["output_hypernetworks_mlps"]):
        for i, lin in enumerate(mlp):
            put_lin(f"output_hypernetworks_mlps.{mi}.layers.{i}", lin)
    for i, lin in enumerate(md["iou_prediction_head"]):
        put_lin(f"iou_prediction_head.layers.{i}", lin)
    return sd


# ---------------------------------------------------------------------------
# the full merged checkpoint (inverse of export.load_reference_checkpoint)
# ---------------------------------------------------------------------------

def medplib_to_hf(params: Mapping[str, Any], cfg: MedplibConfig) -> StateDict:
    """Full tree -> one merged-HF state dict: the LLM under `model.`,
    `lm_head.weight` at the top, the projector / text_hidden_fcs / region
    adapter under their `model.` names and SAM under
    `model.visual_model.*`. CLIP and the ICL modules are not part of the
    merged export."""
    if cfg.moe.enable:
        sd = moe_llama_to_hf(params["llm"], cfg.llm,
                             cfg.moe.layer_indices(cfg.llm.num_layers),
                             cfg.moe.num_experts)
    else:
        sd = llama_to_hf(params["llm"], cfg.llm)
    # nn.Sequential(Linear, GELU, Linear, ...): indices 0, 2, 4, ...
    for i, lin in enumerate(params.get("mm_projector", {}).get("layers", [])):
        sd[f"model.mm_projector.{2 * i}.weight"] = lin["kernel"].t()
        sd[f"model.mm_projector.{2 * i}.bias"] = lin["bias"]
    if "region_fea_adapter" in params:
        ra = params["region_fea_adapter"]
        sd["model.region_fea_adapter.weight"] = ra["kernel"].t()
        sd["model.region_fea_adapter.bias"] = ra["bias"]
    if "text_hidden_fcs" in params:
        # Sequential(Linear, ReLU, Linear, Dropout): indices 0 and 2
        t = params["text_hidden_fcs"]
        for j, fc in ((0, "fc1"), (2, "fc2")):
            sd[f"model.text_hidden_fcs.0.{j}.weight"] = t[fc]["kernel"].t()
            sd[f"model.text_hidden_fcs.0.{j}.bias"] = t[fc]["bias"]
    if "sam" in params:
        sd.update(sam_to_torch(params["sam"], cfg.sam,
                               prefix="model.visual_model."))
    return sd


def save_hf_dir(sd: Mapping[str, torch.Tensor], out_dir: str,
                config_json: Optional[str] = None,
                shard_bytes: int = 4 * 1024 ** 3) -> None:
    """Write a state dict as an HF-style directory of safetensors shards:
    model.safetensors, or, past `shard_bytes`, model-0000N-of-0000M.
    safetensors and model.safetensors.index.json (shards split as the
    JAX package's save_hf_dir splits them); plus config.json when
    `config_json` is given."""
    os.makedirs(out_dir, exist_ok=True)
    nb = {k: v.numel() * v.element_size() for k, v in sd.items()}
    shards, cur, cur_bytes = [], [], 0
    for k in sd:
        if cur and cur_bytes + nb[k] > shard_bytes:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(k)
        cur_bytes += nb[k]
    shards.append(cur)
    if len(shards) == 1:
        _safetensors.save_file({k: sd[k] for k in shards[0]},
                               os.path.join(out_dir, "model.safetensors"))
    else:
        index = {"metadata": {"total_size": sum(nb.values())},
                 "weight_map": {}}
        n = len(shards)
        for si, keys in enumerate(shards):
            fname = f"model-{si + 1:05d}-of-{n:05d}.safetensors"
            _safetensors.save_file({k: sd[k] for k in keys},
                                   os.path.join(out_dir, fname))
            for k in keys:
                index["weight_map"][k] = fname
        with open(os.path.join(out_dir,
                               "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    if config_json is not None:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(config_json)
