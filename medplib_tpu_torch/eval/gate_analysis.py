"""MoE router introspection and expert-load plots
(medplib_tpu/eval/gate_analysis.py).

No hooks: a probe forward walks the stack layer by layer and records each
layer's router logits from the post-attention-norm hidden state, then
applies the layer's MLP as serving does (train=False: the grouped matmul
for >= 1024 rows at zero drop, K1 for int4h experts).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.models import llama as llama_lib
from medplib_tpu_torch.models import medplib, moe_llama
from medplib_tpu_torch.ops.attention import causal_attention
from medplib_tpu_torch.ops.norms import rms_norm
from medplib_tpu_torch.ops.rope import rope_cos_sin
from medplib_tpu_torch.train.lora import linear as lora_linear


@torch.no_grad()
def capture_router_logits(params, cfg: MedplibConfig, batch,
                          rp_flag: bool = False) -> Dict[str, np.ndarray]:
    """Run the spliced forward and return per-layer router logits
    [L, B, T, E] (f32) plus the token-kind mask (image vs text slots) and
    the attention mask, as numpy arrays."""
    llm, lcfg, mcfg = params["llm"], cfg.llm, cfg.moe
    embeds, _, attn_mask, _, sm = medplib.splice_batch(
        params, cfg, batch, need_region=rp_flag)
    b, t, _ = embeds.shape
    positions = torch.arange(t, device=embeds.device)[None].expand(b, t)
    cos, sin = rope_cos_sin(positions, lcfg.head_dim, lcfg.rope_theta)
    mlp_apply = moe_llama.make_moe_mlp_apply(lcfg, mcfg, train=False)
    layers = moe_llama._with_flags(llm, lcfg, mcfg)["layers"]

    x, logits = embeds, []
    for i in range(lcfg.num_layers):
        layer_p = llama_lib.layer_params(layers, i)
        h = rms_norm(x, layer_p["input_layernorm"]["weight"],
                     lcfg.rms_norm_eps)
        q, k, v = llama_lib._qkv(layer_p["attn"], h, lcfg, cos, sin)
        attn = causal_attention(q, k, v, attn_mask)
        x = x + lora_linear(layer_p["attn"]["o_proj"], attn.reshape(b, t, -1))
        h2 = rms_norm(x, layer_p["post_attention_layernorm"]["weight"],
                      lcfg.rms_norm_eps)
        logits.append(h2.float() @ layer_p["moe"]["router"]["kernel"].float())
        y, _ = mlp_apply(layer_p, h2)
        x = x + y
    return {
        "router_logits": torch.stack(logits).cpu().numpy(),  # [L, B, T, E]
        "is_image": sm.is_image.cpu().numpy(),               # [B, T]
        "attn_mask": sm.attn_mask.cpu().numpy(),             # [B, T]
    }


def expert_load(capture: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-layer expert selection fractions [L, E] for text vs image
    tokens (the argmax expert of each valid token)."""
    logits = capture["router_logits"]           # [L, B, T, E]
    choice = logits.argmax(-1)                  # [L, B, T]
    L, B, T = choice.shape
    E = logits.shape[-1]
    valid = capture["attn_mask"] > 0
    is_img = capture["is_image"] & valid
    is_txt = (~capture["is_image"]) & valid

    def frac(sel_mask):
        out = np.zeros((L, E))
        for e in range(E):
            hit = (choice == e) & sel_mask[None]
            out[:, e] = hit.reshape(L, -1).sum(-1) / max(
                sel_mask.sum(), 1)
        return out

    return {"text": frac(is_txt), "image": frac(is_img)}


def plot_expert_load(load: Dict[str, np.ndarray], out_path: str):
    """Expert load per layer, text and image tokens side by side (PNG);
    matplotlib is imported here, not with the module."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    L, E = load["text"].shape
    fig, axes = plt.subplots(1, 2, figsize=(12, 4), sharey=True)
    for ax, kind in zip(axes, ("text", "image")):
        for e in range(E):
            ax.plot(range(L), load[kind][:, e], marker="o",
                    label=f"expert {e}")
        ax.set_title(f"{kind} tokens")
        ax.set_xlabel("layer")
        ax.set_ylabel("selection fraction")
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
