"""Plain float32 DeepSeek-V2 decoder as MedPLIB's language model, written
from modeling_deepseek.py (DeepseekV2ForCausalLM, q_lora_rank null) with
torch operations only; it imports nothing of the program.

Per layer: RMSNorm; multi-head latent attention in its expanded form
(q = q_proj(h); the latent c = kv_a_layernorm(kv_a_proj_with_mqa(h)[:r])
and one rope key k_pe shared by the heads; k_nope, v = kv_b_proj(c); YaRN
rope on the interleaved pairs of the rope dims; softmax scale
q_head_dim^-0.5 * mscale(factor, mscale_all_dim)^2); RMSNorm; a dense
SwiGLU for the first `first_k_dense_replace` layers, after them the MoE:
softmax gates in f32, greedy top-k with no capacity, each routed expert's
output times its gate (times routed_scaling_factor), summed, plus the
shared experts' SwiGLU. Departure from the published model: none in the
equations; the linears the configuration stores in int8 / int4 pass
through `quant` first, as in reference/model.py.

Weights come from `portbench.weights` by key path (MoE and dense-MLP
stacks drawn per absolute layer index), one layer at a time.
"""

from __future__ import annotations

import math
from typing import List

import torch

from portbench.reference import quant
from portbench.reference.model import Weights, rms_norm


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, theta: float, rs: dict, device):
    """DeepseekV2YarnRotaryEmbedding's inv_freq and cos / sin factor."""
    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(theta))
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra_f = 1.0 / (theta ** exps)
    inter_f = 1.0 / (rs["factor"] * theta ** exps)
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv = inter_f * (1 - mask) + extra_f * mask
    return inv, (yarn_mscale(rs["factor"], rs["mscale"])
                 / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))


def softmax_scale(model: dict) -> float:
    scale = (model["qk_nope_head_dim"] + model["qk_rope_head_dim"]) ** -0.5
    rs = model.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope(x, pos, model):
    """x [.., T, D] in the interleaved-pair layout -> regrouped and
    rotated (apply_rotary_pos_emb)."""
    d = x.shape[-1]
    rs = model.get("rope_scaling")
    if rs:
        inv, msc = yarn_inv_freq(d, model["rope_theta"], rs, x.device)
    else:
        inv = 1.0 / model["rope_theta"] ** (
            torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
        msc = 1.0
    ang = pos.float()[:, None] * inv[None, :]
    cos = torch.cos(ang).repeat(1, 2) * msc
    sin = torch.sin(ang).repeat(1, 2) * msc
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def swiglu(y, g, u, d):
    a = y @ g
    return (a * torch.sigmoid(a) * (y @ u)) @ d


def decoder(W: Weights, model: dict, x: torch.Tensor, lengths: List[int],
            bits: int, rows_per_block: int = 8) -> torch.Tensor:
    """x [N, T, H] (row r real over [0, lengths[r])) -> the final-norm
    hidden states [N, T, H]. The linears stored in int8 (attention, the
    dense and shared MLPs) in `bits`; the routed experts in int4h as the
    configuration pads and groups them (as drawn where expert_bits is
    16); the router as drawn."""
    h, L, eps = (model["hidden_size"], model["num_hidden_layers"],
                 model["rms_norm_eps"])
    heads, r = model["num_attention_heads"], model["kv_lora_rank"]
    dn, dr, dv = (model["qk_nope_head_dim"], model["qk_rope_head_dim"],
                  model["v_head_dim"])
    e, k = model["n_routed_experts"], model["num_experts_per_tok"]
    m, kd = model["moe_intermediate_size"], model["first_k_dense_replace"]
    srv = model["serving"]
    scale = softmax_scale(model)
    n, t, _ = x.shape
    dev = x.device
    valid = (torch.arange(t, device=dev)[None, :]
             < torch.as_tensor(lengths, device=dev)[:, None])
    pos = torch.arange(t, device=dev)
    causal = pos[None, :] <= pos[:, None]

    def lin(w, in_axis):
        return quant.linear_weight(w, in_axis, bits)

    for i in range(L):
        def w(name, shape):
            return W(f"llm/layers/{name}", shape, i)
        qw = lin(w("attn/q_proj/kernel", (heads * (dn + dr), h)), 1)
        kva = lin(w("attn/kv_a_proj_with_mqa/kernel", (h, r + dr)), 0)
        kvb = lin(w("attn/kv_b_proj/kernel", (r, heads * (dn + dv))), 0)
        ow = lin(w("attn/o_proj/kernel", (heads * dv, h)), 0)
        ln1 = w("input_layernorm/weight", (h,))
        lnc = w("attn/kv_a_layernorm/weight", (r,))
        for r0 in range(0, n, rows_per_block):
            xb = x[r0:r0 + rows_per_block]
            nb = xb.shape[0]
            y = rms_norm(xb, ln1, eps)
            q = (y @ qw.t()).reshape(nb, t, heads, dn + dr).transpose(1, 2)
            q_nope, q_pe = q.split([dn, dr], -1)
            ckv = y @ kva
            c = rms_norm(ckv[..., :r], lnc, 1e-6)
            k_pe = rope(ckv[..., r:], pos, model)[:, None]   # [nb, 1, T, dr]
            kv = (c @ kvb).reshape(nb, t, heads, dn + dv).transpose(1, 2)
            k_nope, v = kv.split([dn, dv], -1)
            qf = torch.cat([q_nope, rope(q_pe, pos, model)], -1)
            kf = torch.cat([k_nope, k_pe.expand(nb, heads, t, dr)], -1)
            s = qf @ kf.transpose(-1, -2) * scale
            keep = causal[None, None] & valid[r0:r0 + nb, None, None, :]
            s = s.masked_fill(~keep, float("-inf"))
            o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2)
            x[r0:r0 + nb] = xb + o.reshape(nb, t, heads * dv) @ ow
            del q, kv, qf, kf, s, o, y, c
        del qw, kva, kvb, ow
        ln2 = w("post_attention_layernorm/weight", (h,))
        xs = x[valid]                                    # [tokens, H]
        y = rms_norm(xs, ln2, eps)
        if i < kd:
            hd = model["intermediate_size"]
            mp = "llm/dense_mlp/{}_proj/kernel"
            out = swiglu(y, lin(W(mp.format("gate"), (h, hd), i), 0),
                         lin(W(mp.format("up"), (h, hd), i), 0),
                         lin(W(mp.format("down"), (hd, h), i), 0))
        else:
            out = _moe(W, model, y, i, e, k, m, srv, lin)
        x[valid] = xs + out
        del y, out, xs
    return rms_norm(x, W("llm/norm/weight", (h,)), eps)


def _moe(W, model, y, i, e, k, m, srv, lin):
    """The routed experts and the shared ones over the tokens y [S, H]."""
    h = model["hidden_size"]
    router = W("llm/moe/router/kernel", (h, e), i)
    probs = torch.softmax(y @ router, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if k > 1 and model["norm_topk_prob"]:
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    else:
        gate = gate * model["routed_scaling_factor"]
    out = torch.zeros_like(y)
    ep = "llm/moe/experts/{}_proj/kernel"
    shapes = {"gate": (e, h, m), "up": (e, h, m), "down": (e, m, h)}
    if srv["expert_bits"] == 4:
        ex = {p: quant.padded_experts(W(ep.format(p), s, i),
                                      1 if p == "down" else 2,
                                      srv["expert_pad_align"],
                                      srv["expert_int4_groups"])
              for p, s in shapes.items()}
    else:                                   # a float serving form
        ex = {p: W(ep.format(p), s, i) for p, s in shapes.items()}
    for j in range(e):
        tok, slot = (idx == j).nonzero(as_tuple=True)
        if tok.numel():
            out[tok] += gate[tok, slot, None] * swiglu(
                y[tok], ex["gate"][j], ex["up"][j], ex["down"][j])
    del ex
    ms = m * model["n_shared_experts"]
    sp = "llm/moe/shared_mlp/{}_proj/kernel"
    return out + swiglu(y, lin(W(sp.format("gate"), (h, ms), i), 0),
                        lin(W(sp.format("up"), (h, ms), i), 0),
                        lin(W(sp.format("down"), (ms, h), i), 0))
