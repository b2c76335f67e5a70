"""DeepSeek-V2 as MedPLIB's language model (modeling_deepseek.py's
DeepseekV2ForCausalLM with q_lora_rank null): llama.py's layer loops with
multi-head latent attention (models/mla.py) and DeepSeek's MLP, dense in
the first `first_k_dense_replace` layers and a fine-grained MoE with
shared experts after them (`moe_layer`: ops/moe.topk_moe's routed experts
plus the shared ones). The JAX package has no such model; configs are
config.MlaConfig + config.DeepseekMoeConfig.

Params: llama.py's tree ("embed_tokens", "layers" with the norms and the
MLA "attn" stacked over all L layers, "norm", "lm_head"), plus
"dense_mlp" (a SwiGLU stacked over the k leading dense layers) and "moe"
(stacked over the L - k MoE layers: "router" [H, E], "experts" [E, ...],
"shared_mlp" of width moe_intermediate_size * num_shared_experts).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from medplib_tpu_torch.config import DeepseekMoeConfig, MlaConfig
from medplib_tpu_torch.models import llama, mla
from medplib_tpu_torch.ops.initializers import dense_init, embed_init, normal
from medplib_tpu_torch.ops.moe import topk_moe
from medplib_tpu_torch.utils import profiling

Params = Dict[str, Any]


def _mlp(gen, h: int, m: int, dtype, device, lead) -> Params:
    return {"gate_proj": {"kernel": dense_init(gen, h, m, dtype, device,
                                               lead)},
            "up_proj": {"kernel": dense_init(gen, h, m, dtype, device, lead)},
            "down_proj": {"kernel": dense_init(gen, m, h, dtype, device,
                                               lead)}}


def init_deepseek_v2(gen: torch.Generator, cfg: MlaConfig,
                     moe_cfg: DeepseekMoeConfig, dtype=torch.float32,
                     vocab_size: Optional[int] = None,
                     device="cuda") -> Params:
    """Random params in the layout above."""
    vocab = vocab_size or cfg.vocab_size
    h, L = cfg.hidden_size, cfg.num_layers
    kd = moe_cfg.first_k_dense_replace
    e, m = moe_cfg.num_experts, moe_cfg.moe_intermediate_size
    ones = lambda *s: torch.ones(s, dtype=dtype, device=device)  # noqa: E731
    return {
        "embed_tokens": {"embedding": embed_init(gen, vocab, h, dtype,
                                                 device)},
        "layers": {"input_layernorm": {"weight": ones(L, h)},
                   "attn": mla.init_attn(gen, cfg, dtype, device, (L,)),
                   "post_attention_layernorm": {"weight": ones(L, h)}},
        "dense_mlp": _mlp(gen, h, cfg.intermediate_size, dtype, device,
                          (kd,)),
        "moe": {
            "router": {"kernel": normal(gen, (L - kd, h, e), dtype, device,
                                        h ** -0.5)},
            "experts": {
                "gate_proj": {"kernel": normal(gen, (L - kd, e, h, m), dtype,
                                               device, h ** -0.5)},
                "up_proj": {"kernel": normal(gen, (L - kd, e, h, m), dtype,
                                             device, h ** -0.5)},
                "down_proj": {"kernel": normal(gen, (L - kd, e, m, h), dtype,
                                               device, m ** -0.5)}},
            "shared_mlp": _mlp(gen, h, m * moe_cfg.num_shared_experts, dtype,
                               device, (L - kd,)),
        },
        "norm": {"weight": ones(h)},
        "lm_head": {"kernel": dense_init(gen, h, vocab, dtype, device)},
    }


def moe_layer(moe_p: Params, h: torch.Tensor, moe_cfg: DeepseekMoeConfig,
              decode: bool = False) -> torch.Tensor:
    """One MoE layer: the routed experts (ops/moe.topk_moe, routed for
    the phase) plus the shared experts' SwiGLU ("shared_mlp")."""
    y = topk_moe(moe_p, h, moe_cfg, decode=decode)
    with profiling.span("moe.shared"):
        return y + llama.dense_mlp(moe_p["shared_mlp"], h)


def make_mlp_apply(params: Params, moe_cfg: DeepseekMoeConfig,
                   decode: bool = False):
    """llama's MlpApply for this stack: layer i (layer_p["layer_idx"])
    runs the dense MLP below first_k_dense_replace, `moe_layer` after."""
    kd = moe_cfg.first_k_dense_replace

    def apply(layer_p: Params, h: torch.Tensor):
        i = layer_p["layer_idx"]
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        if i < kd:
            return llama.dense_mlp(
                llama.layer_params(params["dense_mlp"], i), h), zero
        return moe_layer(llama.layer_params(params["moe"], i - kd), h,
                         moe_cfg, decode), zero

    return apply


def forward(params: Params, cfg: MlaConfig, moe_cfg: DeepseekMoeConfig,
            input_embeds: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[mla.LatentCache] = None):
    """Prefill (into `cache` when given) -> (hidden_post_norm, cache, 0)."""
    return llama.forward(params, cfg, input_embeds, attn_mask, positions,
                         make_mlp_apply(params, moe_cfg), cache)


def forward_decode(params: Params, cfg: MlaConfig,
                   moe_cfg: DeepseekMoeConfig, input_embeds: torch.Tensor,
                   cache: mla.LatentCache):
    """One decode step over the latent cache (written in place) ->
    (hidden [B, 1, H], cache with length + 1)."""
    return llama.forward_decode(params, cfg, input_embeds, cache,
                                make_mlp_apply(params, moe_cfg, True))
