"""MoE LLaMA: the dense decoder with per-layer mixture-of-experts MLPs
(medplib_tpu/models/moe_llama.py).

The MoE MLP plugs into models/llama.py's blocks as `mlp_apply`. Whether the
zero-drop grouped-matmul path engages follows the JAX gates exactly
(`stack_experts_for_gmm`): inference, top-1, capacity >= S, every layer MoE,
int8 (kernel K3) or int4h(G=2) (kernel K1) experts of pad-free shapes, and
S >= 1024 at prefill. At decode only int4h experts try it, with 32-row
tiles, which selects the fused decode kernel K2; int8 experts keep the
capacity-sort path there, as in JAX. The JAX whole-stack view with a
per-layer gid offset was a workaround for XLA slice copies; here each
layer passes its own [E, ...] view, which is free.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from medplib_tpu_torch.config import LlamaConfig, MoeConfig
from medplib_tpu_torch.models import llama
from medplib_tpu_torch.ops.initializers import normal
from medplib_tpu_torch.ops.moe import capacity_for, moe_mlp

Params = Dict[str, Any]


def init_experts(gen, cfg: LlamaConfig, moe_cfg: MoeConfig, dtype, device,
                 lead=()) -> Params:
    e, h, m = moe_cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    lead = tuple(lead)
    return {
        "gate_proj": {"kernel": normal(gen, lead + (e, h, m), dtype, device,
                                       h ** -0.5)},
        "up_proj": {"kernel": normal(gen, lead + (e, h, m), dtype, device,
                                     h ** -0.5)},
        "down_proj": {"kernel": normal(gen, lead + (e, m, h), dtype, device,
                                       m ** -0.5)},
    }


def init_moe_llama(gen: torch.Generator, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   dtype=torch.float32, vocab_size: Optional[int] = None,
                   device="cuda") -> Params:
    params = llama.init_llama(gen, cfg, dtype, vocab_size, device)
    L, h, e = cfg.num_layers, cfg.hidden_size, moe_cfg.num_experts
    if moe_cfg.use_residual:
        raise NotImplementedError("Residual-MoE is not ported yet")
    params["layers"]["moe"] = {
        "router": {"kernel": normal(gen, (L, h, e), dtype, device,
                                    h ** -0.5)},
        "experts": init_experts(gen, cfg, moe_cfg, dtype, device, (L,)),
    }
    return params


def strip_dense_mlp(params: Params, cfg: LlamaConfig,
                    moe_cfg: MoeConfig) -> Params:
    """Drop the dense MLP stack when every layer is MoE. Mutates."""
    idx = moe_cfg.layer_indices(cfg.num_layers)
    if len(idx) == cfg.num_layers and "mlp" in params["layers"]:
        del params["layers"]["mlp"]
    return params


def moe_flags(cfg: LlamaConfig, moe_cfg: MoeConfig) -> np.ndarray:
    """[L] int32, 1 where the layer MLP is MoE."""
    idx = set(moe_cfg.layer_indices(cfg.num_layers))
    return np.asarray([1 if i in idx else 0 for i in range(cfg.num_layers)],
                      np.int32)


def _best_k_block(k: int, cap: int = 2048) -> int:
    """Largest multiple of 128 <= cap dividing k (k if none): the JAX gmm
    pads K (a copy) when this is below 1024 (gmm.py:_pick_bk)."""
    for mult in range(min(cap, k) // 128, 0, -1):
        if k % (128 * mult) == 0:
            return 128 * mult
    return k


def stack_experts_for_gmm(experts: Params, moe_cfg: MoeConfig, s_tokens: int,
                          train: bool, decode: bool = False) -> bool:
    """The JAX eligibility conditions of the whole-stack gmm dispatch
    (moe_llama.py:141-177), for stacked [L, E, ...] expert nodes: exactly
    equivalent to the capacity semantics, and shapes the kernels stream."""
    if train or moe_cfg.top_k != 1:
        return False
    e = moe_cfg.num_experts
    cap = capacity_for(s_tokens, e, moe_cfg.eval_capacity_factor,
                       moe_cfg.min_capacity)
    if cap < s_tokens:
        return False          # sort could drop tokens
    if s_tokens < 1024 and not decode:
        return False          # prefill: sort at small S
    for n in ("gate_proj", "up_proj", "down_proj"):
        node = experts[n]
        k = node["kernel"]
        if k.dim() != 4 or k.shape[1] != e:
            return False
        if "scale" in node and k.dtype == torch.int8:
            # int8 experts stream through K3; the JAX gate rejects shapes
            # its kernel would have to pad (K block < 1024, N % 512)
            if _best_k_block(k.shape[-2]) < 1024 or k.shape[-1] % 512:
                return False
        elif not ("scale4h" in node and node["scale4h"].shape[-3] == 2
                  and k.shape[-2] % 128 == 0 and k.shape[-1] % 512 == 0):
            return False
    return True


def make_moe_mlp_apply(cfg: LlamaConfig, moe_cfg: MoeConfig,
                       train: bool = True, stacked: bool = False,
                       block_m: int = 512):
    flags = moe_flags(cfg, moe_cfg)
    if not bool(np.all(flags == 1)):
        raise NotImplementedError("mixed dense / MoE layer stacks are not "
                                  "ported yet (moe_mode must be 'dense')")

    def apply(layer_p: Params, x: torch.Tensor):
        return moe_mlp(layer_p["moe"], x, moe_cfg, train=train,
                       dispatch_mode="gmm" if stacked else "auto",
                       block_m=block_m, stacked=stacked)

    return apply


def forward(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
            input_embeds, attn_mask=None, positions=None, cache=None,
            train: bool = True):
    """-> (hidden_post_norm, cache, router_aux_loss_sum)."""
    b, t = input_embeds.shape[:2]
    stacked = stack_experts_for_gmm(params["layers"]["moe"]["experts"],
                                    moe_cfg, b * t, train)
    mlp_apply = make_moe_mlp_apply(cfg, moe_cfg, train, stacked)
    return llama.forward(params, cfg, input_embeds, attn_mask, positions,
                         mlp_apply, cache)


def forward_decode(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   input_embeds, cache):
    """One decode step. int4h(G=2) expert trees route the expert MLP
    through the whole-stack gmm dispatch at 32-row tiles, i.e. the fused
    decode kernel K2 (the JAX default); other trees, int8 experts
    included, take the sort path."""
    experts = params["layers"]["moe"]["experts"]
    int4h = ("scale4h" in experts["gate_proj"]
             and experts["gate_proj"]["scale4h"].shape[-3] == 2)
    stacked = int4h and stack_experts_for_gmm(
        experts, moe_cfg, input_embeds.shape[0], train=False, decode=True)
    mlp_apply = make_moe_mlp_apply(cfg, moe_cfg, train=False, stacked=stacked,
                                   block_m=32 if stacked else 512)
    return llama.forward_decode(params, cfg, input_embeds, cache, mlp_apply)


def forward_extend(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   input_embeds, cache, c0):
    """Chunked-prefill extend with the MoE MLP: the chunk's B*C rows take
    the prefill's dispatch at S = B*C (the grouped matmul from 1024 rows,
    K1 for int4h experts; the capacity-sort path below)."""
    b, c = input_embeds.shape[:2]
    stacked = stack_experts_for_gmm(params["layers"]["moe"]["experts"],
                                    moe_cfg, b * c, train=False)
    mlp_apply = make_moe_mlp_apply(cfg, moe_cfg, train=False,
                                   stacked=stacked)
    return llama.forward_extend(params, cfg, input_embeds, cache, c0,
                                mlp_apply)
