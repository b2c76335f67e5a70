"""MoE LLaMA: the dense decoder with per-layer mixture-of-experts MLPs
(medplib_tpu/models/moe_llama.py).

The MoE MLP plugs into models/llama.py's blocks as `mlp_apply`. Each MoE
layer call's route (the capacity sort, the grouped matmuls K1 / K3, the
fused decode kernel K2 or the expert-parallel grouped matmuls) is
ops/moe.plan_route's; the stack tells it the phase and whether every
layer is MoE, which the JAX whole-stack gate needs. The JAX whole-stack
view with a per-layer gid offset was a workaround for XLA slice copies;
here each layer passes its own [E, ...] view, which is free. Under a mesh
with ep_shard and an expert axis the experts of that view are the rank's
[E/ep, ...] block: shard_params leaves the expert kernels whole (the JAX
param_spec replicates them), so a whole-stack [L * E/ep, ...] view of
the rank's experts would be a copy of the stack.

Layer selection (moe_mode dense / sparse / first_half / second_half, or
moe_layers_idx) gives a per-layer 0/1 flag: a layer flagged 0 runs the
dense MLP of its "mlp" params and adds no aux loss (a Python branch on the
numpy flag; JAX takes a lax.cond). Router and expert stacks cover every
layer. Residual-MoE trees carry "residual_mlp" (a dense MLP stack, its own
buffers) and "coefficient" beside the experts (`residual_mix`).
Stage-4 expert surgery, expert e seeded from donor e's dense MLP, is
`build_experts_from_donors`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from medplib_tpu_torch.config import LlamaConfig, MoeConfig
from medplib_tpu_torch.models import llama
from medplib_tpu_torch.ops.initializers import normal
from medplib_tpu_torch.ops.moe import moe_mlp
from medplib_tpu_torch.train.lora import dequant_kernel

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
    params["layers"]["moe"] = {
        "router": {"kernel": normal(gen, (L, h, e), dtype, device,
                                    h ** -0.5)},
        "experts": init_experts(gen, cfg, moe_cfg, dtype, device, (L,)),
    }
    if moe_cfg.use_residual:
        # the dense copy seeded from the dense MLP (deepspeed deep-copies
        # the expert), in buffers of its own so the two never alias
        moe = params["layers"]["moe"]
        moe["residual_mlp"] = {n: {k: v.clone() for k, v in node.items()}
                               for n, node in params["layers"]["mlp"].items()}
        moe["coefficient"] = {
            "kernel": normal(gen, (L, h, 2), dtype, device, h ** -0.5),
            "bias": torch.zeros((L, 2), dtype=dtype, device=device)}
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


def residual_mix(moe_p: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Residual-MoE (deepspeed MoE(use_residual=True)): the experts'
    output y mixed with a dense SwiGLU copy of the layer's MLP by a learned
    2-way softmax of the token. The coefficient is taken in f32 (f32
    kernel, f32 bias, f32 softmax), then cast to x.dtype; y·c0 + r·c1 is
    formed in x.dtype."""
    r_out = llama.dense_mlp(moe_p["residual_mlp"], x)    # TP-aware
    ck = moe_p["coefficient"]
    coef = x.float() @ dequant_kernel(ck, torch.float32).float()
    coef = torch.softmax(coef + ck["bias"].float(), dim=-1).to(x.dtype)
    return (y.to(x.dtype) * coef[..., 0:1]
            + r_out.to(x.dtype) * coef[..., 1:2])


def make_moe_mlp_apply(cfg: LlamaConfig, moe_cfg: MoeConfig,
                       train: bool = True, ep_shard: bool = False,
                       decode: bool = False):
    """MlpApply for llama.forward / forward_decode (decode=True) /
    forward_extend. In a mixed stack the layer params carry "moe_flag"
    (`_with_flags`)."""
    all_moe = bool(np.all(moe_flags(cfg, moe_cfg) == 1))

    def apply(layer_p: Params, x: torch.Tensor):
        if all_moe or layer_p["moe_flag"]:
            mp = layer_p["moe"]
            y, aux = moe_mlp(mp, x, moe_cfg, train=train, ep_shard=ep_shard,
                             decode=decode, all_moe=all_moe)
            if "residual_mlp" in mp:
                y = residual_mix(mp, x, y)
            return y, aux
        return (llama.dense_mlp(layer_p["mlp"], x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    return apply


def _with_flags(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig
                ) -> Params:
    """params with layers["moe_flag"], one Python int per layer (a shallow
    copy; the tensors are shared)."""
    layers = dict(params["layers"])
    layers["moe_flag"] = tuple(int(f) for f in moe_flags(cfg, moe_cfg))
    return dict(params, layers=layers)


def forward(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
            input_embeds, attn_mask=None, positions=None, cache=None,
            remat: bool = False, train: bool = True, ep_shard: bool = False):
    """-> (hidden_post_norm, cache, router_aux_loss_sum). remat checkpoints
    each layer (training): the recompute routes as the forward did (a
    stable sort of the same logits)."""
    return llama.forward(_with_flags(params, cfg, moe_cfg), cfg,
                         input_embeds, attn_mask, positions,
                         make_moe_mlp_apply(cfg, moe_cfg, train, ep_shard),
                         cache, remat)


def forward_decode(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   input_embeds, cache, ep_shard: bool = False):
    """One decode step: int4h(G=2) expert trees of an all-MoE stack take
    the fused decode kernel K2 (the JAX default), or under ep_shard with
    an expert axis the expert-parallel gmm (K1 at the decode tile); other
    trees, int8 experts included, and mixed stacks the capacity sort
    (ops/moe.plan_route)."""
    return llama.forward_decode(
        _with_flags(params, cfg, moe_cfg), cfg, input_embeds, cache,
        make_moe_mlp_apply(cfg, moe_cfg, False, ep_shard, decode=True))


def forward_extend(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   input_embeds, cache, c0, ep_shard: bool = False):
    """Chunked-prefill extend with the MoE MLP: the chunk's B*C rows take
    the prefill's route at S = B*C (the grouped matmul from 1024 rows,
    K1 for int4h experts; the capacity-sort path below)."""
    return llama.forward_extend(
        _with_flags(params, cfg, moe_cfg), cfg, input_embeds, cache, c0,
        make_moe_mlp_apply(cfg, moe_cfg, False, ep_shard))


def build_experts_from_donors(donor_mlp_stacks) -> Params:
    """Expert surgery: expert e of every MoE layer from donor checkpoint
    e's dense MLP (e=0 the stage-3 seg specialist, e=1 the stage-2 VQA
    one). donor_mlp_stacks: per expert {"gate_proj" / "up_proj" /
    "down_proj": {"kernel": [L, in, out]}} (llama_from_hf's "mlp").
    -> experts with kernels [L, E, in, out] (new buffers)."""
    return {n: {"kernel": torch.stack([d[n]["kernel"]
                                       for d in donor_mlp_stacks], dim=1)}
            for n in ("gate_proj", "up_proj", "down_proj")}
