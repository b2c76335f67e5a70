"""The yardstick's arithmetic for a DeepSeek-V2 configuration (multi-head
latent attention, top-k fine-grained MoE with shared experts, dense
leading layers): the operations a served call needs and the least time
of K1, K2 and K4 at q / k 192, v 128. Peaks and `bound` are counts.py's.
Expert widths are the published ones (the padding the serving form adds
is not work the model needs); routed rows are tokens x top-k.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence, Tuple

from portbench import counts
from portbench.counts import BF16_FLOPS, INT8_OPS, bound


def _moe_layers(model: dict) -> int:
    return model["num_hidden_layers"] - model["first_k_dense_replace"]


def attn_flops(model: dict, n_new: int, pairs: float,
               ctx: float = 0.0) -> float:
    """One MLA layer for n_new tokens: the projections (q_proj,
    kv_a_proj_with_mqa, kv_b_proj over the new latents, o_proj) and the
    core. Prefill (ctx 0): the expanded form, pairs kept (query, key)
    pairs at 2·(dn + dr) + 2·dv FLOP a head. Decode (ctx = the cached
    positions attended, n_new = 1): the absorbed form, q_nope into the
    latent and the output back out of it through kv_b_proj's halves, and
    scores and the weighted sum over ctx latents of r + dr / r values."""
    h, n = model["hidden_size"], model["num_attention_heads"]
    r, dn = model["kv_lora_rank"], model["qk_nope_head_dim"]
    dr, dv = model["qk_rope_head_dim"], model["v_head_dim"]
    proj = 2 * n_new * (h * n * (dn + dr) + h * (r + dr) + n * dv * h)
    if not ctx:
        expand = 2 * n_new * r * n * (dn + dv)
        return proj + expand + 2 * pairs * n * (dn + dr + dv)
    absorb = 2 * n_new * n * r * (dn + dv)
    return proj + absorb + 2 * ctx * n * (r + dr + r)


def mlp_flops(model: dict, layer: int, n_new: int) -> float:
    """The MLP of `layer` for n_new tokens: the dense SwiGLU below
    first_k_dense_replace; after it the router, top-k routed experts and
    the shared experts' SwiGLU."""
    h = model["hidden_size"]
    if layer < model["first_k_dense_replace"]:
        return 2 * n_new * 3 * h * model["intermediate_size"]
    m, k = model["moe_intermediate_size"], model["num_experts_per_tok"]
    return (2 * n_new * h * model["n_routed_experts"]
            + k * 2 * n_new * 3 * h * m
            + 2 * n_new * 3 * h * m * model["n_shared_experts"])


def serve_call_flops(model: dict, prompt_lens: Iterable[int],
                     new_tokens: int) -> float:
    """A grounded generate call, as counts.serve_call_flops counts one:
    per row CLIP, the projector, SAM's encoder and one mask decode, the
    prefill over its spliced tokens, lm_head and the SEG capture, then
    `new_tokens` decode steps over the growing cache."""
    med = model["medplib"]
    h, L = model["hidden_size"], model["num_hidden_layers"]
    vp, od = med["vocab_size_padded"], med["seg"]["out_dim"]
    n_img = (med["vision"]["image_size"] // med["vision"]["patch_size"]) ** 2
    head, fcs = 2 * h * vp, 2 * (h * h + h * od)
    per_image = (counts.clip_flops(med["vision"])
                 + counts.projector_flops(med["projector"], n_img, h)
                 + counts.sam_encoder_flops(med["sam"])
                 + counts.sam_decoder_flops(med["sam"]))
    mlp1 = sum(mlp_flops(model, i, 1) for i in range(L))
    total = 0.0
    for n in prompt_lens:
        total += per_image + L * attn_flops(model, n, n * (n + 1) / 2)
        total += n * mlp1 + head + 2 * fcs
        for j in range(new_tokens):
            total += L * attn_flops(model, 1, 0.0, n + j + 1) + mlp1 \
                + head + fcs
    return total


def k1_bound_s(model: dict, rows: int) -> float:
    """K1 over one prefill of `rows` (padded) tokens: per MoE layer gate,
    up and down over rows x top-k routed rows, W4A8, at the int8 peak or
    the bytes (int8 rows, every expert's int4 weight and scales, bf16
    out), whichever is larger."""
    h, m = model["hidden_size"], model["moe_intermediate_size"]
    e, g = model["n_routed_experts"], model["serving"]["expert_int4_groups"]
    routed = rows * model["num_experts_per_tok"]
    total = 0.0
    for k, n in ((h, m), (h, m), (m, h)):
        ops = 2.0 * routed * k * n
        by = routed * k + e * (k * n // 2 + g * n * 4) + routed * n * 2
        total += bound(by, ops, INT8_OPS)[0]
    return _moe_layers(model) * total


def k2_bound_s(model: dict, rows: int, steps: int) -> float:
    """K2 over `steps` decode steps of `rows` rows: per MoE layer the
    int4 weights and scales of the experts the rows can reach (min(E,
    rows x top-k)), the rows in and out, at the HBM rate (the routed
    operations are far below)."""
    h, m = model["hidden_size"], model["moe_intermediate_size"]
    e, g = model["n_routed_experts"], model["serving"]["expert_int4_groups"]
    k = model["num_experts_per_tok"]
    experts = min(e, rows * k)
    by = experts * (3 * h * m // 2 + g * (2 * m + h) * 4) + 2 * rows * h * 2
    ops = 2.0 * rows * k * 3 * h * m
    return _moe_layers(model) * steps * bound(by, ops, INT8_OPS)[0]


def k4_bound_s(model: dict, prompt_lens: Sequence[int],
               padded: int) -> Tuple[float, str]:
    """K4 at q / k 192, v 128 over one prefill (one launch a layer): the
    kept (query, key) pairs of the padded batch (every query row, keys
    causal and real) at 2·(dn + dr) + 2·dv FLOP a pair and head at the
    bf16 peak, or the bytes (q and k of dn + dr, v and out of dv, in
    bf16; lse f32), whichever is larger. -> (seconds, which)."""
    n = model["num_attention_heads"]
    dqk = model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
    dv = model["v_head_dim"]
    b = len(prompt_lens)
    pairs = sum(p * (p + 1) / 2 + (padded - p) * p for p in prompt_lens)
    rows = b * padded * n
    by = rows * (2 * dqk + 2 * dv) * 2 + rows * 4
    s, which = bound(by, pairs * n * (2 * dqk + 2 * dv), BF16_FLOPS)
    return model["num_hidden_layers"] * s, which


_K4_192 = re.compile(r"flash_fwd_mma_kernel<\s*192\s*,\s*128\s*>")


def k4_192_s(ops: Iterable[Tuple[str, float]]) -> float:
    """Device seconds of the K4 <192, 128> instantiation in a profile's
    [(kernel name, seconds)]."""
    return sum(s for name, s in ops if _K4_192.search(name))


def launches_per_call(model: dict, batch: int, new_tokens: int) -> dict:
    """The counted launches of one grounded call: K1 three a MoE layer at
    prefill (gate, up, down), K2 once a MoE layer a decode step per 64
    rows, K4 <192, 128> once a layer, and no plain attention."""
    moe = _moe_layers(model)
    return {"K1": 3 * moe, "K2": moe * new_tokens * -(-batch // 64),
            "K4_qk192": model["num_hidden_layers"], "plain_attention": 0}
