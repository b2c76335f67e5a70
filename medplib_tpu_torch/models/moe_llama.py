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

Under a mesh with ep_shard and an expert axis (`mesh_ep_shards`), the
eligible path is the expert-parallel gmm (ops/moe._gmm_moe_ep), at decode
too (K1 at 32-row tiles, three calls a layer, never K2); the gates then
also need E % ep == 0 and S % row shards == 0, and read the global S.
Each layer still passes its own view, the rank's [E/ep, ...] block with
gid offset 0: shard_params leaves the expert kernels whole (the JAX
param_spec replicates them), so a whole-stack [L * E/ep, ...] view of
the rank's experts would be a copy of the stack.

Layer selection (moe_mode dense / sparse / first_half / second_half, or
moe_layers_idx) gives a per-layer 0/1 flag: a layer flagged 0 runs the
dense MLP of its "mlp" params and adds no aux loss (a Python branch on the
numpy flag; JAX takes a lax.cond). Router and expert stacks cover every
layer. Residual-MoE trees carry "residual_mlp" (a dense MLP stack, its own
buffers) and "coefficient" beside the experts (ops/moe._apply_residual).
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


def _best_k_block(k: int, cap: int = 2048) -> int:
    """Largest multiple of 128 <= cap dividing k (k if none): the JAX gmm
    pads K (a copy) when this is below 1024 (gmm.py:_pick_bk)."""
    for mult in range(min(cap, k) // 128, 0, -1):
        if k % (128 * mult) == 0:
            return 128 * mult
    return k


def mesh_ep_shards() -> tuple:
    """(expert axis size, data * expert row shards) of the ambient mesh;
    (1, 1) outside any mesh."""
    from medplib_tpu_torch.parallel.mesh import AXIS_EXPERT, current_mesh
    mesh = current_mesh()
    if mesh is None:
        return 1, 1
    ep = mesh.size(AXIS_EXPERT)
    return ep, mesh.size("data") * ep


def stack_experts_for_gmm(experts: Params, moe_cfg: MoeConfig, s_tokens: int,
                          train: bool, ep_shard: bool = False,
                          decode: bool = False, ep: int = 1,
                          row_shards: int = 1) -> bool:
    """The JAX eligibility conditions of the whole-stack gmm dispatch
    (moe_llama.py:115-177), for stacked [L, E, ...] expert nodes: exactly
    equivalent to the capacity semantics, and shapes the kernels stream.
    s_tokens is the global S. ep_shard with ep > 1 is the expert-parallel
    variant (E % ep == 0, S % row_shards == 0); ep_shard without an
    expert axis is not eligible (the sort dispatch runs)."""
    if train or moe_cfg.top_k != 1:
        return False
    ep_mode = ep_shard and ep > 1
    if ep_shard and not ep_mode:
        return False      # ep_shard requested but no expert axis in scope
    e = moe_cfg.num_experts
    if ep_mode and (e % ep or s_tokens % max(row_shards, 1)):
        return False
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
                       block_m: int = 512, ep_shard: bool = False,
                       ep_size: int = 1):
    """MlpApply for llama.forward / forward_decode / forward_extend. In a
    mixed stack the layer params carry "moe_flag" (`_with_flags`).
    ep_size > 1 marks the stacked path as expert-parallel
    (ops/moe._gmm_moe_ep over the layer's [E/ep, ...] block: gid offset
    0, see the module docstring)."""
    all_moe = bool(np.all(moe_flags(cfg, moe_cfg) == 1))

    def apply(layer_p: Params, x: torch.Tensor):
        if all_moe or layer_p["moe_flag"]:
            return moe_mlp(layer_p["moe"], x, moe_cfg, train=train,
                           ep_shard=ep_shard or ep_size > 1,
                           dispatch_mode="gmm" if stacked else "auto",
                           block_m=block_m, stacked=stacked)
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


def _stacked_apply(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   rows: int, train: bool, ep_shard: bool,
                   decode: bool = False, block_m: int = 512):
    """The MlpApply of one pass over `rows` local rows: the whole-stack
    gmm dispatch where stack_experts_for_gmm deems it exact at the global
    S (all-MoE stacks only), expert-parallel under ep_shard with an
    expert axis."""
    from medplib_tpu_torch.parallel.mesh import row_shards as global_rows
    ep, row_shards = mesh_ep_shards() if ep_shard else (1, 1)
    s_glob = rows * global_rows()
    stacked = bool(np.all(moe_flags(cfg, moe_cfg) == 1)) and \
        stack_experts_for_gmm(params["layers"]["moe"]["experts"], moe_cfg,
                              s_glob, train, ep_shard, decode, ep,
                              row_shards)
    return make_moe_mlp_apply(cfg, moe_cfg, train, stacked,
                              block_m if stacked else 512, ep_shard,
                              ep if stacked else 1)


def forward(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
            input_embeds, attn_mask=None, positions=None, cache=None,
            remat: bool = False, train: bool = True, ep_shard: bool = False,
            unroll: bool = False):
    """-> (hidden_post_norm, cache, router_aux_loss_sum). remat checkpoints
    each layer (training): the recompute routes as the forward did (a
    stable sort of the same logits). unroll: the JAX package's
    Python-unrolled layer loop; the port's loop is always one, so it
    changes nothing."""
    b, t = input_embeds.shape[:2]
    mlp_apply = _stacked_apply(params, cfg, moe_cfg, b * t, train, ep_shard)
    return llama.forward(_with_flags(params, cfg, moe_cfg), cfg,
                         input_embeds, attn_mask, positions, mlp_apply,
                         cache, remat, unroll)


def forward_decode(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   input_embeds, cache, ep_shard: bool = False,
                   unroll: bool = False):
    """One decode step. int4h(G=2) expert trees route the expert MLP
    through the whole-stack gmm dispatch at 32-row tiles, i.e. the fused
    decode kernel K2 (the JAX default), or under ep_shard with an expert
    axis the expert-parallel gmm (K1 at 32-row tiles); other trees, int8
    experts included, and mixed stacks take the sort path."""
    experts = params["layers"]["moe"]["experts"]
    int4h = ("scale4h" in experts["gate_proj"]
             and experts["gate_proj"]["scale4h"].shape[-3] == 2)
    if int4h:
        mlp_apply = _stacked_apply(params, cfg, moe_cfg,
                                   input_embeds.shape[0], False, ep_shard,
                                   decode=True, block_m=32)
    else:
        mlp_apply = make_moe_mlp_apply(cfg, moe_cfg, train=False,
                                       ep_shard=ep_shard)
    return llama.forward_decode(_with_flags(params, cfg, moe_cfg), cfg,
                                input_embeds, cache, mlp_apply, unroll)


def forward_extend(params: Params, cfg: LlamaConfig, moe_cfg: MoeConfig,
                   input_embeds, cache, c0, ep_shard: bool = False):
    """Chunked-prefill extend with the MoE MLP: the chunk's B*C rows take
    the prefill's dispatch at S = B*C (the grouped matmul from 1024 rows,
    K1 for int4h experts; the capacity-sort path below)."""
    b, c = input_embeds.shape[:2]
    mlp_apply = _stacked_apply(params, cfg, moe_cfg, b * c, False, ep_shard)
    return llama.forward_extend(_with_flags(params, cfg, moe_cfg), cfg,
                                input_embeds, cache, c0, mlp_apply)


def build_experts_from_donors(donor_mlp_stacks) -> Params:
    """Expert surgery: expert e of every MoE layer from donor checkpoint
    e's dense MLP (e=0 the stage-3 seg specialist, e=1 the stage-2 VQA
    one). donor_mlp_stacks: per expert {"gate_proj" / "up_proj" /
    "down_proj": {"kernel": [L, in, out]}} (llama_from_hf's "mlp").
    -> experts with kernels [L, E, in, out] (new buffers)."""
    return {n: {"kernel": torch.stack([d[n]["kernel"]
                                       for d in donor_mlp_stacks], dim=1)}
            for n in ("gate_proj", "up_proj", "down_proj")}
