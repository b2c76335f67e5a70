"""Weight translation: HF / PyTorch state dicts -> the port's param trees
(medplib_tpu/utils/hf_weights.py).

Reads the layouts of the released checkpoints (MedPLIB-7b-2e merged HF
export, sam-med2d_b.pth, openai/clip-vit-large-patch14-336): kernels are
transposed to the trees' [in, out] layout (q/k/v stay [out, in]),
convolutions to HWIO, and per-layer weights are stacked on a leading layer
axis. Leaves keep the state dict's dtype and device (a bf16 checkpoint
stays bf16: widening a 7B model to float32 would double its memory), and
every leaf is contiguous. Values equal the JAX loader's leaf for leaf
after widening.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import ClipVisionConfig, LlamaConfig, SamConfig


def to_torch(x) -> torch.Tensor:
    """A state-dict value -> a torch tensor (numpy bf16, which torch cannot
    wrap, goes through an exact float32 hop)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _get(sd, key, transpose=False) -> torch.Tensor:
    w = to_torch(sd[key])
    return (w.t() if transpose else w).contiguous()


def _stack(sd: Mapping[str, Any], template: str, num: int, transpose=False):
    ws = [to_torch(sd[template.format(i=i)]) for i in range(num)]
    return torch.stack([w.t() if transpose else w for w in ws])


def _linear(sd, prefix, transpose=True, bias=True):
    out = {"kernel": _get(sd, prefix + ".weight", transpose)}
    if bias and prefix + ".bias" in sd:
        out["bias"] = _get(sd, prefix + ".bias")
    return out


def _hwio(sd, key) -> torch.Tensor:
    """torch conv weight [out, in, kh, kw] -> HWIO [kh, kw, in, out]."""
    return to_torch(sd[key]).permute(2, 3, 1, 0).contiguous()


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------

def llama_from_hf(sd: Mapping[str, Any], cfg: LlamaConfig,
                  prefix: str = "model.") -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict -> init_llama()-shaped tree.
    `prefix` is the LlamaModel's path in the checkpoint."""
    L = cfg.num_layers
    lt = prefix + "layers.{i}."

    def stk(sub, transpose=True):
        return _stack(sd, lt + sub + ".weight", L, transpose=transpose)

    layers = {
        "input_layernorm": {"weight": stk("input_layernorm", False)},
        "attn": {
            "q_proj": {"kernel": stk("self_attn.q_proj", False)},
            "k_proj": {"kernel": stk("self_attn.k_proj", False)},
            "v_proj": {"kernel": stk("self_attn.v_proj", False)},
            "o_proj": {"kernel": stk("self_attn.o_proj")},
        },
        "post_attention_layernorm": {
            "weight": stk("post_attention_layernorm", False)},
        "mlp": {
            "gate_proj": {"kernel": stk("mlp.gate_proj")},
            "up_proj": {"kernel": stk("mlp.up_proj")},
            "down_proj": {"kernel": stk("mlp.down_proj")},
        },
    }
    return {
        "embed_tokens": {"embedding": _get(sd, prefix
                                           + "embed_tokens.weight")},
        "layers": layers,
        "norm": {"weight": _get(sd, prefix + "norm.weight")},
        "lm_head": {"kernel": _get(sd, "lm_head.weight", transpose=True)},
    }


def moe_llama_from_hf(sd: Mapping[str, Any], cfg: LlamaConfig,
                      moe_layer_indices, num_experts: int,
                      prefix: str = "model.") -> Dict[str, Any]:
    """MedPLIB MoE export -> moe_llama tree. DeepSpeed MoE layers appear
    in merged checkpoints as
      layers.{i}.mlp.deepspeed_moe.gate.wg.weight  [E, H]
      layers.{i}.mlp.deepspeed_moe.experts.deepspeed_experts.{e}.{gate,up,down}_proj.weight
    Router and expert stacks cover every layer; the rows of non-MoE layers
    are zeros and never read. Residual-MoE checkpoints also carry
    layers.{i}.mlp.mlp.* (the dense copy) and layers.{i}.mlp.coefficient.*
    (the mixing head); they load, though the forward does not run them
    yet."""
    dense = {k: v for k, v in sd.items() if ".mlp.deepspeed_moe" not in k}
    dense.update(_dense_mlp_placeholder(sd, cfg, prefix))
    params = llama_from_hf(dense, cfg, prefix)
    zeros = _zeros_like(sd, prefix)
    lt = prefix + "layers.{i}.mlp.deepspeed_moe."
    L, E = cfg.num_layers, num_experts
    h, m = cfg.hidden_size, cfg.intermediate_size
    moe_set = set(moe_layer_indices)
    # one flat list of [in, out] views per stack, stacked once: no
    # per-layer copies, so loading takes no memory beyond the tree
    routers, ws = [], {"gate_proj": [], "up_proj": [], "down_proj": []}
    for i in range(L):
        base = lt.format(i=i)
        if i in moe_set:
            routers.append(to_torch(sd[base + "gate.wg.weight"]).t())
        else:
            routers.append(zeros(h, E))
        for name, acc in ws.items():
            for e in range(E):
                if i in moe_set:
                    acc.append(to_torch(sd[f"{base}experts.deepspeed_experts."
                                           f"{e}.{name}.weight"]).t())
                else:
                    acc.append(zeros(m, h) if name == "down_proj"
                               else zeros(h, m))
    params["layers"]["moe"] = {
        "router": {"kernel": torch.stack(routers)},
        "experts": {name: {"kernel": torch.stack(acc).reshape(
            (L, E) + acc[0].shape)} for name, acc in ws.items()},
    }

    res_probe = prefix + "layers.{i}.mlp.mlp.gate_proj.weight"
    if any(res_probe.format(i=i) in sd for i in moe_set):
        res = {"gate_proj": [], "up_proj": [], "down_proj": []}
        ck, cb = [], []
        for i in range(L):
            rb = prefix + f"layers.{i}.mlp."
            present = i in moe_set and rb + "mlp.gate_proj.weight" in sd
            for name, acc in res.items():
                if present:
                    acc.append(to_torch(sd[rb + f"mlp.{name}.weight"]).t())
                else:
                    acc.append(zeros(m, h) if name == "down_proj"
                               else zeros(h, m))
            ck.append(to_torch(sd[rb + "coefficient.weight"]).t() if present
                      else zeros(h, 2))
            cb.append(to_torch(sd[rb + "coefficient.bias"]) if present
                      else zeros(2))
        params["layers"]["moe"]["residual_mlp"] = {
            name: {"kernel": torch.stack(acc)} for name, acc in res.items()}
        params["layers"]["moe"]["coefficient"] = {
            "kernel": torch.stack(ck), "bias": torch.stack(cb)}
    return params


def _zeros_like(sd, prefix):
    """-> zeros(*shape): a zero view (no memory of its own) in the
    checkpoint's dtype, on its device; stacking copies it."""
    like = to_torch(sd[prefix + "embed_tokens.weight"])
    one = torch.zeros((), dtype=like.dtype, device=like.device)
    return lambda *shape: one.expand(shape)


def _dense_mlp_placeholder(sd, cfg: LlamaConfig, prefix):
    """MoE layers carry no dense MLP weights; zeros stand in so the layer
    stack is uniform. The MoE path never reads them;
    moe_llama.strip_dense_mlp drops them when every layer is MoE."""
    zeros = _zeros_like(sd, prefix)
    out = {}
    h, m = cfg.hidden_size, cfg.intermediate_size
    for i in range(cfg.num_layers):
        for name, shape in (("gate_proj", (m, h)), ("up_proj", (m, h)),
                            ("down_proj", (h, m))):
            key = f"{prefix}layers.{i}.mlp.{name}.weight"
            if key not in sd:
                out[key] = zeros(*shape)
    return out


# ---------------------------------------------------------------------------
# CLIP vision tower (HF CLIPVisionModel)
# ---------------------------------------------------------------------------

def clip_vision_from_hf(sd: Mapping[str, Any], cfg: ClipVisionConfig,
                        prefix: str = "vision_model.") -> Dict[str, Any]:
    L = cfg.num_layers
    lt = prefix + "encoder.layers.{i}."

    def stk_lin(sub):
        return {"kernel": _stack(sd, lt + sub + ".weight", L, True),
                "bias": _stack(sd, lt + sub + ".bias", L)}

    def stk_ln(sub):
        return {"weight": _stack(sd, lt + sub + ".weight", L),
                "bias": _stack(sd, lt + sub + ".bias", L)}

    def ln(sub):
        return {"weight": _get(sd, prefix + sub + ".weight"),
                "bias": _get(sd, prefix + sub + ".bias")}

    emb = prefix + "embeddings."
    return {
        "embeddings": {
            "class_embedding": _get(sd, emb + "class_embedding"),
            "patch_embedding": {
                "kernel": _hwio(sd, emb + "patch_embedding.weight")},
            "position_embedding": {
                "embedding": _get(sd, emb + "position_embedding.weight")},
        },
        "pre_layrnorm": ln("pre_layrnorm"),
        "layers": {
            "layer_norm1": stk_ln("layer_norm1"),
            "layer_norm2": stk_ln("layer_norm2"),
            "attn": {
                "q_proj": stk_lin("self_attn.q_proj"),
                "k_proj": stk_lin("self_attn.k_proj"),
                "v_proj": stk_lin("self_attn.v_proj"),
                "out_proj": stk_lin("self_attn.out_proj"),
            },
            "mlp": {"fc1": stk_lin("mlp.fc1"), "fc2": stk_lin("mlp.fc2")},
        },
        "post_layernorm": ln("post_layernorm"),
    }


# ---------------------------------------------------------------------------
# SAM-Med2D (sam-med2d_b.pth: {"model": {...}} with image_encoder /
# prompt_encoder / mask_decoder subtrees)
# ---------------------------------------------------------------------------

def sam_from_torch(sd: Mapping[str, Any], cfg: SamConfig) -> Dict[str, Any]:
    if "model" in sd and not any(k.startswith("image_encoder") for k in sd):
        sd = sd["model"]
    p = "image_encoder."
    enc = {
        "patch_embed": {"kernel": _hwio(sd, p + "patch_embed.proj.weight"),
                        "bias": _get(sd, p + "patch_embed.proj.bias")},
        "pos_embed": _get(sd, p + "pos_embed"),   # [1, Hp, Wp, C]
    }
    L = cfg.encoder_depth
    lt = p + "blocks.{i}."

    def stk_lin(sub, bias=True):
        d = {"kernel": _stack(sd, lt + sub + ".weight", L, True)}
        if bias:
            d["bias"] = _stack(sd, lt + sub + ".bias", L)
        return d

    def stk_ln(sub):
        return {"weight": _stack(sd, lt + sub + ".weight", L),
                "bias": _stack(sd, lt + sub + ".bias", L)}

    def stk_rel_pos(sub):
        # window blocks hold [2 ws - 1, d] tables, global blocks
        # [2 grid - 1, d]: zero-pad to the longest (rows past 2 size - 1
        # are never read)
        ws = [to_torch(sd[lt.format(i=i) + sub]) for i in range(L)]
        n = max(w.shape[0] for w in ws)
        return torch.stack([F.pad(w, (0, 0, 0, n - w.shape[0]))
                            for w in ws])

    blocks = {
        "norm1": stk_ln("norm1"),
        "attn": {
            "qkv": stk_lin("attn.qkv"),
            "proj": stk_lin("attn.proj"),
            "rel_pos_h": stk_rel_pos("attn.rel_pos_h"),
            "rel_pos_w": stk_rel_pos("attn.rel_pos_w"),
        },
        "norm2": stk_ln("norm2"),
        "mlp": {"lin1": stk_lin("mlp.lin1"), "lin2": stk_lin("mlp.lin2")},
    }
    if cfg.use_adapter:
        # Adapter_Layer per block: SE channel gate (channel.0 / channel.2,
        # no bias), spatial conv (spatial.0, HWIO) + transposed conv
        # (spatial.2, kept in torch's [Cin, Cout, kh, kw]), LayerNorm
        blocks["adapter"] = {
            "channel_fc1": {"kernel": _stack(
                sd, lt + "Adapter.channel.0.weight", L, True)},
            "channel_fc2": {"kernel": _stack(
                sd, lt + "Adapter.channel.2.weight", L, True)},
            "spatial_conv": {"kernel": torch.stack([
                _hwio(sd, lt.format(i=i) + "Adapter.spatial.0.weight")
                for i in range(L)])},
            "spatial_convt": {"kernel": _stack(
                sd, lt + "Adapter.spatial.2.weight", L)},
            "norm": stk_ln("Adapter.norm"),
        }
    enc["blocks"] = blocks
    enc["neck"] = {
        "conv1": {"kernel": _hwio(sd, p + "neck.0.weight")},
        "ln1": {"weight": _get(sd, p + "neck.1.weight"),
                "bias": _get(sd, p + "neck.1.bias")},
        "conv2": {"kernel": _hwio(sd, p + "neck.2.weight")},
        "ln2": {"weight": _get(sd, p + "neck.3.weight"),
                "bias": _get(sd, p + "neck.3.bias")},
    }

    q = "prompt_encoder."
    pe = {
        "pe_layer": {"gaussian_matrix": _get(
            sd, q + "pe_layer.positional_encoding_gaussian_matrix")},
        "point_embeddings": torch.stack([
            to_torch(sd[f"{q}point_embeddings.{i}.weight"])[0]
            for i in range(4)]),
        "not_a_point_embed": _get(sd, q + "not_a_point_embed.weight")[0],
        "no_mask_embed": _get(sd, q + "no_mask_embed.weight")[0],
        "mask_downscaling": _sam_mask_downscaling(sd),
    }
    return {"image_encoder": enc, "prompt_encoder": pe,
            "mask_decoder": _sam_mask_decoder(sd, cfg)}


def _sam_mask_downscaling(sd):
    p = "prompt_encoder.mask_downscaling."

    def conv(i):
        return {"kernel": _hwio(sd, p + f"{i}.weight"),
                "bias": _get(sd, p + f"{i}.bias")}

    def ln(i):
        return {"weight": _get(sd, p + f"{i}.weight"),
                "bias": _get(sd, p + f"{i}.bias")}

    return {"conv1": conv(0), "ln1": ln(1), "conv2": conv(3), "ln2": ln(4),
            "conv3": conv(6)}


def _sam_mask_decoder(sd, cfg: SamConfig):
    p = "mask_decoder."

    def lin(name):
        return _linear(sd, p + name)

    def mlp_list(template, n_layers):
        return [{"kernel": _get(sd, template.format(i=i) + ".weight", True),
                 "bias": _get(sd, template.format(i=i) + ".bias")}
                for i in range(n_layers)]

    def attn_block(prefix):
        return {n: lin(prefix + "." + n)
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def ln(name):
        return {"weight": _get(sd, p + name + ".weight"),
                "bias": _get(sd, p + name + ".bias")}

    tl = []
    for i in range(cfg.decoder_depth):
        b = f"transformer.layers.{i}"
        tl.append({
            "self_attn": attn_block(b + ".self_attn"),
            "norm1": ln(b + ".norm1"),
            "cross_attn_token_to_image": attn_block(
                b + ".cross_attn_token_to_image"),
            "norm2": ln(b + ".norm2"),
            "mlp": {"lin1": lin(b + ".mlp.lin1"),
                    "lin2": lin(b + ".mlp.lin2")},
            "norm3": ln(b + ".norm3"),
            "cross_attn_image_to_token": attn_block(
                b + ".cross_attn_image_to_token"),
            "norm4": ln(b + ".norm4"),
        })
    num_mask_tokens = cfg.num_multimask_outputs + 1
    up = p + "output_upscaling."
    return {
        "iou_token": _get(sd, p + "iou_token.weight"),
        "mask_tokens": _get(sd, p + "mask_tokens.weight"),
        "transformer": {
            "layers": tl,
            "final_attn_token_to_image": attn_block(
                "transformer.final_attn_token_to_image"),
            "norm_final_attn": ln("transformer.norm_final_attn"),
        },
        "output_upscaling": {     # transposed convs keep torch's layout
            "convt1": {"kernel": _get(sd, up + "0.weight"),
                       "bias": _get(sd, up + "0.bias")},
            "ln": {"weight": _get(sd, up + "1.weight"),
                   "bias": _get(sd, up + "1.bias")},
            "convt2": {"kernel": _get(sd, up + "3.weight"),
                       "bias": _get(sd, up + "3.bias")},
        },
        "output_hypernetworks_mlps": [
            mlp_list(p + f"output_hypernetworks_mlps.{m}.layers.{{i}}", 3)
            for m in range(num_mask_tokens)],
        "iou_prediction_head": mlp_list(
            p + "iou_prediction_head.layers.{i}", cfg.iou_head_depth),
    }


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point leaf to `dtype` (integer leaves, e.g.
    int8 kernels, stay)."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
