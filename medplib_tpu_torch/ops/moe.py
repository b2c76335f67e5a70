"""Mixture-of-Experts MLP: top-k router with DeepSpeed capacity semantics
and its dispatches (medplib_tpu/ops/moe.py).

- "sort": capacity dispatch by a stable sort of tokens by expert (exact
  DeepSpeed slot order; tokens beyond capacity are dropped);
- "einsum": the same capacity semantics as one-hot [S, E, C] dispatch and
  combine tensors (the GShard form; `top1_gate` / `top2_gate`);
- "gmm": the zero-drop grouped-matmul dispatch, top-1 only: rows in a
  group-aligned buffer through three grouped matmuls (gate, up, down):
  kernel K3 for int8 and float experts, K1 for int4h(G=2) experts; or, on
  a decode route, the fused int4h kernel K2; exactly equivalent to "sort"
  when capacity >= S;
- "ragged": top-1 with no capacity, each expert contracting only its own
  tokens (`_ragged_moe`, the JAX package's jax.lax.ragged_dot dispatch);
- "auto": the route `plan_route` gives the layer call.

`plan_route` is the one place a layer call's route is decided: sort,
the grouped matmuls, K2 or the expert-parallel grouped matmuls, their
tile and the kind of each expert weight, from the phase, train or
inference, top-k, E, the global S and capacity, the expert layout, the
mesh's expert axis and whether every layer of the stack is MoE. It holds
the JAX package's gates (moe_llama.stack_experts_for_gmm, moe_mlp's auto
branch, forward_decode's int4h test and _gmm_moe's decode-tile test).

Under a mesh (parallel/mesh.set_mesh) the tokens are this rank's rows of
a global batch, and every dispatch returns what one process returns on the
global batch: S, the capacity, the route and the aux loss are the
global ones, and the capacity dispatches route on the all-gathered router
logits (slot positions in global token order; top-2 second choices after
every first choice of the batch). With ep_shard and an expert axis, each
rank computes only its own experts' block (`_gmm_moe_ep` for the zero-drop
gmm path, the expert-group capacity dispatch otherwise); without
ep_shard an expert leaf that shard_params split over the expert axis is
all-gathered. Outside a mesh the capacity dispatches run on a 1-rank mesh
(local_mesh, every collective an identity): one process takes the same
code as each rank.

DeepSeek-V2's fine-grained MoE (`topk_moe`, config.DeepseekMoeConfig; no
counterpart in the JAX package): softmax in f32, greedy top-k with no
capacity, every (token, expert) pair through the grouped matmuls (K1 for
int4h experts) at prefill, or at decode through the fused kernel K2
taking the k experts of each row in one pass; the gated outputs summed in
f32. The caller (models/deepseek_v2.py) adds the shared experts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import MoeConfig
from medplib_tpu_torch.ops.activations import silu
from medplib_tpu_torch.ops.cuda.gmm import align_rows, gmm, gmm_int4h
from medplib_tpu_torch.ops.cuda.moe_decode import (fused_decode_eligible,
                                                   moe_ffn_decode_int4h)
from medplib_tpu_torch.ops.cuda.moe_prefill import (moe_dispatch_quant,
                                                    moe_swiglu_quant,
                                                    moe_topk_combine)
from medplib_tpu_torch.parallel.mesh import (AXIS_EXPERT, ROWS,
                                             current_mesh, local_mesh,
                                             row_shards, row_sum)
from medplib_tpu_torch.train.lora import dequant_kernel
from medplib_tpu_torch.utils import profiling
from medplib_tpu_torch.utils.quantize import (act_quant_enabled,
                                              int4h_expert_einsum)


def capacity_for(num_tokens: int, num_experts: int, capacity_factor: float,
                 min_capacity: int) -> int:
    return max(math.ceil(num_tokens / num_experts * capacity_factor),
               min_capacity)


class GateOutput(NamedTuple):
    combine: torch.Tensor        # [S, E, C] f32 combine weights
    dispatch: torch.Tensor       # [S, E, C] bool one-hot dispatch mask
    aux_loss: torch.Tensor       # scalar load-balancing loss
    expert_counts: torch.Tensor  # [E] tokens routed per expert (pre-drop)


def _slot_weights(g: torch.Tensor, mask: torch.Tensor, loc: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """[S, E, C]: g at (token, its kept expert, its slot), else 0."""
    slot = F.one_hot(loc.clamp(0, capacity - 1), capacity).float()
    return g[:, None, None] * mask[:, :, None].float() * slot[:, None, :]


def top1_gate(logits: torch.Tensor, capacity: int) -> GateOutput:
    """DeepSpeed top1gating (no noise policy, drop_tokens=True): softmax
    gates, position in expert by cumsum, tokens past capacity dropped."""
    e = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(gates, dim=-1)
    onehot = F.one_hot(idx, e)
    aux = _aux_loss(gates, idx, e)
    loc_s = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    mask1 = onehot * (loc_s < capacity)[:, None]
    gate_s = (gates * mask1).sum(-1)
    combine = _slot_weights(gate_s, mask1, loc_s, capacity)
    return GateOutput(combine, combine > 0.0, aux, onehot.sum(0))


def top2_gate(logits: torch.Tensor, capacity: int) -> GateOutput:
    """DeepSpeed top2gating: the second expert by a masked argmax, second
    choices ranked after every first choice, gates renormalized by their
    sum after dropping, aux loss from the top-1 assignment only."""
    e = logits.shape[-1]
    gates = torch.softmax(logits.float(), dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    m1 = F.one_hot(idx1, e)
    idx2 = torch.argmax(gates.masked_fill(m1.bool(), -math.inf), dim=-1)
    m2 = F.one_hot(idx2, e)
    aux = _aux_loss(gates, idx1, e)
    loc1 = ((torch.cumsum(m1, 0) - m1) * m1).sum(-1)
    loc2 = ((torch.cumsum(m2, 0) - m2 + m1.sum(0, keepdim=True))
            * m2).sum(-1)
    mask1 = m1 * (loc1 < capacity)[:, None]
    mask2 = m2 * (loc2 < capacity)[:, None]
    g1 = (gates * mask1).sum(-1)
    g2 = (gates * mask2).sum(-1)
    denom = (g1 + g2).clamp(min=1e-9)
    combine = (_slot_weights(g1 / denom, mask1, loc1, capacity)
               + _slot_weights(g2 / denom, mask2, loc2, capacity))
    return GateOutput(combine, combine > 0.0, aux, (m1 + m2).sum(0))


def gate(logits: torch.Tensor, k: int, capacity: int) -> GateOutput:
    if k == 1:
        return top1_gate(logits, capacity)
    if k == 2:
        return top2_gate(logits, capacity)
    raise NotImplementedError(f"top-{k} gating")


class SortDispatch(NamedTuple):
    slot_token: torch.Tensor   # [E*C] source token (S for empty slots)
    token_slot: torch.Tensor   # [S*k] destination slot (E*C if dropped)
    token_prob: torch.Tensor   # [S*k] combine weight (0 if dropped)
    token_src: torch.Tensor    # [S*k] original token id
    aux_loss: torch.Tensor


def _aux_loss(gates: torch.Tensor, idx: torch.Tensor, e: int):
    me = gates.mean(0)
    ce = F.one_hot(idx, e).float().mean(0)
    return (me * ce).sum() * e


def sort_dispatch(logits: torch.Tensor, k: int, capacity: int) -> SortDispatch:
    """DeepSpeed-equivalent routing via a stable sort: entries laid out
    [all 1st choices in token order, then 2nd choices], stably sorted by
    expert, ranked within expert, dropped at rank >= capacity."""
    s, e = logits.shape
    dev = logits.device
    gates = torch.softmax(logits.float(), dim=-1)
    experts, probs = [], []
    masked = gates
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)
        experts.append(idx)
        probs.append(torch.gather(gates, 1, idx[:, None])[:, 0])
        masked = masked.masked_fill(F.one_hot(idx, e).bool(), -math.inf)
    flat_expert = torch.cat(experts)
    flat_prob = torch.cat(probs)
    flat_token = torch.arange(s, device=dev).repeat(k)
    aux = _aux_loss(gates, experts[0], e)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    group_start = torch.searchsorted(sorted_expert, sorted_expert,
                                     right=False)
    rank = torch.arange(s * k, device=dev) - group_start
    keep = rank < capacity
    slot_of_sorted = torch.where(keep, sorted_expert * capacity + rank,
                                 torch.full_like(rank, e * capacity))
    token_slot = torch.empty_like(slot_of_sorted)
    token_slot[order] = slot_of_sorted
    token_prob = torch.where(token_slot < e * capacity, flat_prob,
                             torch.zeros_like(flat_prob))
    if k == 2:
        # top2gating normalizes after capacity dropping
        p1, p2 = token_prob[:s], token_prob[s:]
        denom = (p1 + p2).clamp(min=1e-9)
        token_prob = torch.cat([p1 / denom, p2 / denom])
        token_prob = torch.where(token_slot < e * capacity, token_prob,
                                 torch.zeros_like(token_prob))
    slot_token = torch.full((e * capacity + 1,), s, dtype=torch.long,
                            device=dev)
    slot_token[slot_of_sorted] = flat_token[order]   # dropped -> extra slot
    return SortDispatch(slot_token=slot_token[:-1], token_slot=token_slot,
                        token_prob=token_prob, token_src=flat_token,
                        aux_loss=aux)


def _aux_loss_rows(gates: torch.Tensor, idx: torch.Tensor, e: int):
    """_aux_loss of a rank's rows over the global batch: the means are
    global (row sums over the mesh's row shards)."""
    if current_mesh() is None:
        return _aux_loss(gates, idx, e)
    n = gates.shape[0] * row_shards()
    sums = row_sum(torch.cat([gates.sum(0),
                              F.one_hot(idx, e).float().sum(0)])) / n
    return (sums[:e] * sums[e:]).sum() * e


def _route_top1(logits: torch.Tensor):
    """softmax in f32, first-maximum argmax, the top prob as the gate."""
    e = logits.shape[-1]
    with profiling.span("moe.route", S=logits.shape[0]):
        gates = torch.softmax(logits.float(), dim=-1)
        idx = torch.argmax(gates, dim=-1)
        gate_s = torch.gather(gates, 1, idx[:, None])[:, 0]
        return idx, gate_s, _aux_loss_rows(gates, idx, e)


def _route_topk(xs: torch.Tensor, router: torch.Tensor, k: int,
                scaling: float, norm_topk_prob: bool):
    """DeepSeek-V2's MoEGate (scoring softmax, topk_method greedy) of the
    rows xs [S, H] under the router kernel [H, E]: f32 logits, softmax,
    the k largest probabilities and their experts; the weights are the
    probabilities times `scaling`, or with norm_topk_prob (and k > 1)
    renormalized to sum to 1. -> (idx [S, k], weights [S, k] f32)."""
    with profiling.span("moe.route", S=xs.shape[0], k=k,
                        E=router.shape[-1]):
        scores = torch.softmax(xs.float() @ router.float(), dim=-1)
        w, idx = torch.topk(scores, k, dim=-1)
        if k > 1 and norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        else:
            w = w * scaling
        return idx, w


# ---------------------------------------------------------------------------
# the route of one layer call
# ---------------------------------------------------------------------------

# The gates tuned on the TPU, each with its one home here: the grouped
# matmuls take a prefill from GMM_MIN_ROWS global rows, and a decode step
# runs at the decode tile, which is what selects K2 (the JAX package's
# block_m <= 64 test).
GMM_MIN_ROWS = 1024
PREFILL_BLOCK_M = 512
DECODE_BLOCK_M = 32
_FFN = ("gate_proj", "up_proj", "down_proj")


class Route(NamedTuple):
    """How one MoE layer call runs (`plan_route`): the dispatch ("sort",
    "einsum", "ragged", "gmm", "gmm_ep" the expert-parallel gmm, or
    "fused_decode", K2 in A8), the group-aligned buffer's tile on the
    grouped routes (None on the others) and the kind of the gate / up /
    down weights (`_weight_kind`)."""
    dispatch: str
    block_m: Optional[int]
    kinds: Tuple[str, ...]


def _weight_kind(node) -> str:
    """How the grouped matmuls take one expert weight: "int8" (K3 with
    the per-channel scale at its epilogue), "int4h" (G=2: K1) or "dense"
    (float, finer int4h: a dequantized copy through K3's float mode)."""
    k = node["kernel"]
    if "scale" in node and k.dtype == torch.int8:
        return "int8"
    if ("scale4h" in node and node["scale4h"].shape[-3] == 2
            and k.shape[-2] % 128 == 0):
        return "int4h"
    return "dense"


def _best_k_block(k: int, cap: int = 2048) -> int:
    """Largest multiple of 128 <= cap dividing k (k if none): the JAX gmm
    pads K (a copy) when this is below 1024 (gmm.py:_pick_bk)."""
    for mult in range(min(cap, k) // 128, 0, -1):
        if k % (128 * mult) == 0:
            return 128 * mult
    return k


def _whole_stack_shapes(experts, kinds, e: int) -> bool:
    """The expert shapes JAX's whole-stack gate admits (moe_llama.py:
    stack_experts_for_gmm): [E, K, N] int8 or int4h(G=2) nodes that its
    kernels stream with no padding copy (N % 512; int8 also a K block of
    at least 1024)."""
    for n, kind in zip(_FFN, kinds):
        k = experts[n]["kernel"]
        if (k.dim() != 3 or k.shape[0] != e or kind == "dense"
                or k.shape[-1] % 512
                or kind == "int8" and _best_k_block(k.shape[-2]) < 1024):
            return False
    return True


def plan_route(experts, num_experts: int, top_k: int, s_glob: int, *,
               decode: bool, train: bool = False,
               capacity: Optional[int] = None, all_moe: bool = False,
               ep_shard: bool = False, ep: int = 1,
               mode: str = "auto") -> Route:
    """The route of one MoE layer call over the layer's expert nodes as
    the caller holds them ([E, ...] leaves).

    decode: the call is one decode step. capacity: the DeepSpeed capacity
    at the global S (s_glob) of a top-1 / top-2 layer; None for a greedy
    top-k layer with no capacity (DeepSeek-V2), whose every (token,
    expert) pair is computed, so the grouped matmuls are exact at any S.
    all_moe: every layer of the caller's stack is MoE. ep: the ranks of
    the mesh's expert axis that ep_shard splits the experts over (1
    without one). mode: "auto", or the dispatch the caller names ("gmm"
    still takes the expert-parallel form under ep_shard and K2 at
    decode).

    Under a capacity, "auto" holds the JAX gates. The grouped matmuls
    equal the capacity dispatch only in inference at top-1 with capacity
    >= S. A decode step takes them at the decode tile only on the
    whole-stack path: an all-MoE stack of int4h experts whose shapes the
    kernels stream, and under ep_shard an expert axis that divides E. A
    prefill takes them from GMM_MIN_ROWS rows, and under ep_shard only on
    the whole-stack path (any quantized kind). A decode step off that
    path is routed as a prefill. On the grouped route under ep_shard the
    experts are expert-parallel, and otherwise a decode tile selects K2
    where its shapes allow."""
    if mode not in ("auto", "gmm", "sort", "einsum", "ragged"):
        raise ValueError(f"unknown dispatch_mode {mode!r}")
    kinds = tuple(_weight_kind(experts[n]) for n in _FFN)
    if mode not in ("auto", "gmm"):
        return Route(mode, None, kinds)
    if mode == "auto" and capacity is not None:
        exact = not train and top_k == 1 and capacity >= s_glob
        whole = (all_moe and (kinds[0] == "int4h" or not decode)
                 and (not ep_shard or ep > 1 and num_experts % ep == 0)
                 and _whole_stack_shapes(experts, kinds, num_experts))
        if not exact or ep_shard and not whole:
            return Route("sort", None, kinds)
        if not (decode and whole):
            if s_glob < GMM_MIN_ROWS:
                return Route("sort", None, kinds)
            decode = False                  # the prefill's tile
    block_m = DECODE_BLOCK_M if decode else PREFILL_BLOCK_M
    if ep_shard and ep > 1:
        return Route("gmm_ep", block_m, kinds)
    if decode and fused_decode_eligible(experts, num_experts):
        return Route("fused_decode", block_m, kinds)
    return Route("gmm", block_m, kinds)


def _routed_experts(xs: torch.Tensor, idx: torch.Tensor, gate, experts,
                    e: int, route: Route, combine) -> torch.Tensor:
    """The routed SwiGLU of the rows xs [S, H] over one layer's experts,
    idx / gate [S] or [S, k] each row's experts and combine weights, under
    the span moe.experts. On a "fused_decode" route K2 in A8, which sums
    each row's gated outputs itself; else each (token, expert) row
    through the grouped matmuls at route.block_m (`_gmm_ffn`), the
    outputs combined by the caller's combine(out_al, dest). -> [S, H]."""
    with profiling.span("moe.experts", S=xs.shape[0]) as sp:
        if route.dispatch == "fused_decode":
            return moe_ffn_decode_int4h(xs, experts, idx.to(torch.int32),
                                        gate, e, int8_x=True)
        dest, tile_gid, s_al = align_rows(idx.reshape(-1), e, route.block_m)
        sp.note(Sp=s_al)
        k = idx.shape[1] if idx.dim() == 2 else 1
        out_al = _gmm_ffn(xs, dest, k, s_al, tile_gid, experts, route.kinds,
                          xs.dtype, route.block_m)
        return combine(out_al, dest)


def topk_moe(moe_params, x: torch.Tensor, cfg,
             decode: bool = False) -> torch.Tensor:
    """The routed experts of one DeepSeek-V2 MoE layer. moe_params:
    {"router": {"kernel": [H, E]}, "experts": {gate_proj / up_proj:
    [E, H, M], down_proj: [E, M, H] (int4h, int8 or float)}}; the caller
    adds the shared experts ("shared_mlp"). cfg a
    config.DeepseekMoeConfig. x [B, T, H] -> [B, T, H].

    The route is `plan_route`'s with no capacity. Prefill: the S·k
    (token, expert) rows through align_rows and the grouped SwiGLU
    (`_gmm_ffn`: K1 for int4h(G=2) experts, W4A8 under dynamic_act_quant,
    each token quantized once into its k aligned rows by
    `moe_dispatch_quant`), each token's k gated outputs summed in f32
    (moe_infer's combine; `moe_topk_combine`); decode (int4h experts of
    the fused shapes): K2 in A8 with the k experts of each row."""
    b, t, h = x.shape
    s, k = b * t, cfg.top_k
    xs = x.reshape(s, h)
    router = moe_params["router"]["kernel"]
    e = router.shape[-1]
    idx, w = _route_topk(xs, router, k, cfg.routed_scaling_factor,
                         cfg.norm_topk_prob)
    experts = moe_params["experts"]
    route = plan_route(experts, e, k, s, decode=decode)
    y = _routed_experts(
        xs, idx, w, experts, e, route,
        lambda out_al, dest: moe_topk_combine(out_al, dest, w, x.dtype))
    return y.to(x.dtype).reshape(b, t, h)


def _gmm_moe(xs: torch.Tensor, logits: torch.Tensor, experts, dtype,
             route: Route):
    """Top-1 expert MLP on a "gmm" or "fused_decode" route
    (`_routed_experts`): the grouped matmuls (K3 / K1) over a
    group-aligned buffer, or K2."""
    idx, gate_s, aux = _route_top1(logits)

    def combine(out_al, dest):
        # gate rounded to out_al's dtype, product unrounded (as compiled)
        return (out_al[dest].float()
                * gate_s[:, None].to(out_al.dtype).float()).to(dtype)

    y = _routed_experts(xs, idx, gate_s, experts, logits.shape[-1], route,
                        combine)
    return y.to(dtype), aux


def _gmm_moe_ep(xs: torch.Tensor, logits: torch.Tensor, experts, dtype,
                num_experts: int, ep: int, route: Route):
    """Expert-parallel grouped-matmul dispatch, top-1 (JAX _gmm_moe_ep).

    The rank all-gathers the tokens, expert ids and gates of its expert
    group (the ranks that share its data index), routes them to ITS
    experts (remote tokens go to the dummy group e_loc with a zero gate,
    computed against expert e_loc - 1's weights and dropped by the gate),
    runs one _gmm_ffn over its [E/ep, ...] expert block at route.block_m
    (K1 for int4h(G=2) experts, K3 for int8, three calls at any tile
    size: never the fused decode kernel), and reduce-scatters the rows
    back to their home ranks, where each token holds one nonzero
    contribution. `experts` are the layer's rank-local nodes
    (_expert_view). The aux loss comes from the global logits."""
    mesh = current_mesh()
    e_loc = num_experts // ep
    idx, gate_s, aux = _route_top1(logits)
    ep_idx = mesh.index(AXIS_EXPERT)
    xg = mesh.all_gather(xs, AXIS_EXPERT)
    # expert ids (exact in f32) and gates in one gather
    ig = mesh.all_gather(torch.stack([idx.float(), gate_s], 1), AXIS_EXPERT)
    idxg, gateg = ig[:, 0].long(), ig[:, 1]
    sel = torch.div(idxg, e_loc, rounding_mode="floor") == ep_idx
    lidx = torch.where(sel, idxg - ep_idx * e_loc,
                       torch.full_like(idxg, e_loc))
    gm = torch.where(sel, gateg, torch.zeros_like(gateg))
    dest, tile_gid, s_al = align_rows(lidx, e_loc + 1, route.block_m)
    tile_gid = tile_gid.clamp(max=e_loc - 1)
    out_al = _gmm_ffn(xg, dest, 1, s_al, tile_gid, experts, route.kinds,
                      dtype, route.block_m)
    yg = (out_al[dest].float()
          * gm[:, None].to(out_al.dtype).float()).to(dtype)
    return mesh.reduce_scatter(yg, AXIS_EXPERT), aux


def _ragged_moe(xs: torch.Tensor, logits: torch.Tensor, experts, dtype):
    """Zero-padding top-1 expert MLP (JAX _ragged_moe): tokens stably
    sorted by chosen expert, each expert contracting only its own rows,
    outputs scattered back by the permutation. The JAX package computes
    this with jax.lax.ragged_dot, outside any Pallas kernel, so it is no
    kernel port: one torch.matmul per expert over its group of the sorted
    rows, against the expert's weights dequantized to the activation
    dtype. Exactly the capacity dispatch when capacity >= S."""
    s, h = xs.shape
    e = logits.shape[-1]
    idx, gate_s, aux = _route_top1(logits)
    order = torch.argsort(idx, stable=True)
    sizes = torch.bincount(idx, minlength=e).tolist()
    xs_sorted = xs[order]

    def rag(node, xin):
        w = dequant_kernel(node, xin.dtype)
        return torch.cat([part @ w[g] for g, part in
                          enumerate(torch.split(xin, sizes))])

    h1 = rag(experts["gate_proj"], xs_sorted)
    h2 = rag(experts["up_proj"], xs_sorted)
    out = rag(experts["down_proj"], silu(h1) * h2)
    y_sorted = out * gate_s[order][:, None].to(out.dtype)
    y = xs.new_zeros((s, h), dtype=dtype)
    y[order] = y_sorted.to(dtype)
    return y, aux


def _ffn_specs(experts, kinds, dtype):
    """The grouped SwiGLU's plan (JAX ops/moe.py:_gmm_ffn): {name: (kind,
    weight, scale)} for gate / up / down of `kinds` (`_weight_kind`), a
    "dense" weight dequantized to a one-layer `dtype` copy; and whether
    the inputs are row-quantized (W8A8 / W4A8: under dynamic_act_quant,
    and only when no node is dense)."""
    def spec(node, kind):
        if kind == "dense":
            return kind, dequant_kernel(node, dtype), None
        return kind, node["kernel"], node[
            "scale" if kind == "int8" else "scale4h"].float()

    specs = {n: spec(experts[n], kind) for n, kind in zip(_FFN, kinds)}
    return specs, act_quant_enabled() and "dense" not in kinds


def _gmm_ffn(xs: torch.Tensor, dest: torch.Tensor, k: int, sp: int,
             tile_gid: torch.Tensor, experts, kinds, dtype,
             block_m: int) -> torch.Tensor:
    """SwiGLU of routed rows over a group-aligned buffer of sp rows: each
    token's row of xs [S, H] at its k aligned rows dest [S·k] (token-
    major; gap rows zero), then three grouped matmuls (gate, up, down) per
    `_ffn_specs`. Under act quant each token is quantized once into its
    rows (`moe_dispatch_quant`), which gate and up both read, and the
    activation goes to down as int8 rows and scales from one pass
    (`moe_swiglu_quant`). -> out_al [sp, H]."""
    specs, actq = _ffn_specs(experts, kinds, dtype)

    def mm(xv, spec):
        kind, w, sc = spec
        if kind == "dense":
            return gmm(xv, w, tile_gid, block_m=block_m)
        if actq:
            xq, xsc = xv
            if kind == "int4h":
                return gmm_int4h(xq, w, sc, tile_gid, a_scale=xsc,
                                 block_m=block_m)
            return gmm(xq, w, tile_gid, sc, a_scale=xsc, block_m=block_m)
        if kind == "int4h":
            return gmm_int4h(xv, w, sc, tile_gid, block_m=block_m)
        return gmm(xv, w, tile_gid, sc, block_m=block_m)

    if actq:
        x_in = moe_dispatch_quant(xs, dest, sp, k)
    else:
        x_in = xs.new_zeros((sp, xs.shape[1]))
        x_in[dest] = xs if k == 1 else xs.repeat_interleave(k, dim=0)
    h1 = mm(x_in, specs["gate_proj"])
    h2 = mm(x_in, specs["up_proj"])
    # under act-quant the compiled reference keeps silu(h1) * h2 unrounded
    # (f32) where it feeds the activation quant; bf16 x bf16 is exact in f32
    act = moe_swiglu_quant(h1, h2) if actq else silu(h1) * h2
    return mm(act, specs["down_proj"])


def _expert_mm(node, xin: torch.Tensor) -> torch.Tensor:
    """einsum('ech,ehm->ecm') for the sort dispatch: int4h experts through
    the nibble-plane products, int8 / float through a dequantized copy."""
    if "scale4h" in node and node["kernel"].dim() == 3:
        return int4h_expert_einsum(xin, node["kernel"], node["scale4h"])
    return torch.bmm(xin, dequant_kernel(node, xin.dtype))


def _expert_ffn(ek, expert_in: torch.Tensor) -> torch.Tensor:
    """SwiGLU over [E, C, H] expert buffers."""
    h1 = _expert_mm(ek["gate_proj"], expert_in)
    h2 = _expert_mm(ek["up_proj"], expert_in)
    return _expert_mm(ek["down_proj"], silu(h1) * h2)


def _expert_view(experts, e: int, ep: int):
    """One layer's expert nodes as a dispatch under the ambient mesh needs
    them: with ep > 1, this rank's [E/ep, ...] block of every leaf (a leaf
    that shard_params left whole is narrowed, a free view); with ep == 1,
    whole [E, ...] leaves (a leaf split over the expert axis is
    all-gathered)."""
    mesh = current_mesh()
    if mesh is None:
        return experts
    e_loc = e // ep
    e0 = mesh.index(AXIS_EXPERT) * e_loc

    def leaf(v):
        if ep > 1:
            return v if v.shape[0] == e_loc else v.narrow(0, e0, e_loc)
        return v if v.shape[0] == e else mesh.all_gather(v, AXIS_EXPERT)

    return {n: {k: leaf(v) for k, v in node.items()}
            for n, node in experts.items()}


def _sort_moe(mesh, xs, logits, experts, k: int, capacity: int, e: int,
              ep: int, dtype):
    """The capacity-sort dispatch of a rank's rows (one process: a 1-rank
    mesh, whose collectives are identities).

    Routing is sort_dispatch of the all-gathered logits (global capacity,
    slot order and drops, aux loss from the global gates). The rank then
    serves its expert group's tokens (its own rows, or with ep > 1 the
    rows of every rank that shares its data index, all-gathered) on its
    experts: their kept entries packed into a compact [E/ep, C_loc]
    buffer in global slot order, C_loc = min(C, k group tokens) (when
    the group is the whole batch and ep == 1, the global [E, C] slots
    themselves: packing them cost 3% of a stage-4 step on an H100,
    chip_smoke.py --stage4-step), the
    expert FFN, the combine, and with ep > 1 a reduce-scatter of the
    group's rows back to their ranks (each entry lands on exactly one
    rank, so the sums are those of one process)."""
    s, h = xs.shape
    dev = xs.device
    r, sg = mesh.index(ROWS), s * mesh.size(ROWS)
    logits_g = mesh.all_gather(logits, ROWS)
    d = sort_dispatch(logits_g, k, capacity)
    if ep > 1:
        xs_grp = mesh.all_gather(xs, AXIS_EXPERT)
        g0 = (r // ep) * ep * s
        e0 = mesh.index(AXIS_EXPERT) * (e // ep)
    else:
        xs_grp, g0, e0 = xs, r * s, 0
    e_loc, n = e // ep, xs_grp.shape[0]
    tok = torch.arange(n, device=dev).repeat(k)
    if n == sg and e_loc == e:
        # the group is the whole batch on every expert (one process, or
        # one row shard without ep): the global slots are already compact
        c_loc, slot_tok, lslot, prob = (capacity, d.slot_token,
                                        d.token_slot, d.token_prob)
    else:
        ent = (torch.arange(k, device=dev)[:, None] * sg + g0
               + torch.arange(n, device=dev)[None, :]).reshape(-1)
        slot, prob = d.token_slot[ent], d.token_prob[ent]
        ex = torch.div(slot, capacity, rounding_mode="floor")
        mine = (slot < e * capacity) & (ex >= e0) & (ex < e0 + e_loc)
        key = torch.where(mine, slot, torch.full_like(slot, e * capacity))
        order = torch.argsort(key, stable=True)
        ks = key[order]
        le = torch.where(ks < e * capacity,
                         torch.div(ks, capacity, rounding_mode="floor") - e0,
                         torch.full_like(ks, e_loc))
        rank = torch.arange(len(ks), device=dev) - torch.searchsorted(le, le)
        c_loc = min(capacity, k * n)
        lslot_sorted = torch.where(le < e_loc, le * c_loc + rank,
                                   torch.full_like(le, e_loc * c_loc))
        lslot = torch.empty_like(lslot_sorted)
        lslot[order] = lslot_sorted
        slot_tok = torch.full((e_loc * c_loc + 1,), n, dtype=torch.long,
                              device=dev)
        slot_tok[lslot_sorted] = tok[order]
        slot_tok = slot_tok[:-1]
    xs_pad = torch.cat([xs_grp, xs_grp.new_zeros((1, h))])
    out_e = _expert_ffn(experts, xs_pad[slot_tok].reshape(e_loc, c_loc, h))
    flat_out = torch.cat([out_e.reshape(e_loc * c_loc, h),
                          out_e.new_zeros((1, h))])
    contrib = flat_out[lslot] * prob[:, None].to(out_e.dtype)
    y = xs_grp.new_zeros((n, h), dtype=dtype).index_add_(
        0, tok, contrib.to(dtype))
    if ep > 1:
        y = mesh.reduce_scatter(y, AXIS_EXPERT)
    return y, d.aux_loss


def _einsum_moe(mesh, xs, logits, experts, k: int, capacity: int, e: int,
                ep: int, dtype):
    """The one-hot (GShard) dispatch of a rank's rows (one process: a
    1-rank mesh): the einsums over the all-gathered batch, on this rank's
    experts (with ep > 1 the partial outputs are summed over the expert
    axis), then this rank's rows."""
    s = xs.shape[0]
    r = mesh.index(ROWS)
    xs_g = mesh.all_gather(xs, ROWS)
    g = gate(mesh.all_gather(logits, ROWS), k, capacity)
    e0 = mesh.index(AXIS_EXPERT) * (e // ep) if ep > 1 else 0
    sl = slice(e0, e0 + e // ep)
    expert_in = torch.einsum("sec,sh->ech", g.dispatch[:, sl].to(xs.dtype),
                             xs_g)
    out_e = _expert_ffn(experts, expert_in)
    y = torch.einsum("sec,ech->sh", g.combine[:, sl].to(dtype), out_e)
    if ep > 1:
        y = mesh.all_reduce(y, AXIS_EXPERT)
    return y[r * s:(r + 1) * s], g.aux_loss


def moe_mlp(moe_params, x: torch.Tensor, cfg: MoeConfig, train: bool = True,
            ep_shard: bool = False, dispatch_mode: str = "auto",
            decode: bool = False, all_moe: bool = False):
    """SwiGLU MoE MLP of one layer.

    moe_params: {"router": {"kernel": [H, E]}, "experts": {gate_proj|up_proj:
    {"kernel": [E, H, M] (or int4h [E, H/2, M] + scale4h)}, down_proj: ...}}
    (a Residual-MoE layer's dense copy is mixed in by the caller,
    models/moe_llama.residual_mix). x [B, T, H] -> ([B, T, H], aux_loss).
    dispatch_mode: "sort", "einsum", "gmm", "ragged" or "auto" (module
    docstring); with decode (one decode step) and all_moe (the caller's
    stack is MoE in every layer) the layer's route is `plan_route`'s.
    ep_shard: run the experts expert-parallel over the ambient mesh's
    expert axis (on the grouped route: _gmm_moe_ep)."""
    b, t, h = x.shape
    s = b * t
    xs = x.reshape(s, h)
    e = moe_params["router"]["kernel"].shape[-1]
    mesh = current_mesh()
    s_glob = s * row_shards()
    ep = mesh.size(AXIS_EXPERT) if (mesh is not None and ep_shard) else 1
    cf = cfg.capacity_factor if train else cfg.eval_capacity_factor
    capacity = capacity_for(s_glob, e, cf, cfg.min_capacity)
    logits = xs.float() @ moe_params["router"]["kernel"].float()
    route = plan_route(moe_params["experts"], e, cfg.top_k, s_glob,
                       decode=decode, train=train, capacity=capacity,
                       all_moe=all_moe, ep_shard=ep_shard, ep=ep,
                       mode=dispatch_mode)
    # ragged contracts every expert on the rank's own rows
    experts = _expert_view(moe_params["experts"], e,
                           1 if route.dispatch == "ragged" else ep)

    if route.dispatch == "gmm_ep":
        y, aux = _gmm_moe_ep(xs, logits, experts, x.dtype, e, ep, route)
    elif route.dispatch in ("gmm", "fused_decode"):
        y, aux = _gmm_moe(xs, logits, experts, x.dtype, route)
    elif route.dispatch == "ragged":
        y, aux = _ragged_moe(xs, logits, experts, x.dtype)
    else:
        fn = _sort_moe if route.dispatch == "sort" else _einsum_moe
        y, aux = fn(mesh or local_mesh(), xs, logits, experts, cfg.top_k,
                    capacity, e, ep, x.dtype)
    return y.reshape(b, t, h), aux
