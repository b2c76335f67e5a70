"""The yardstick's arithmetic: the card's peaks, the least time a kernel
could take, the operations a served call needs, and the map from the
port's CUDA kernel names to the kernels of its table (K1-K9).

Peaks are one NVIDIA H100 SXM's published dense rates (no sparsity), which
assume the 700 W power limit; every result names the card's limit beside
them.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def bound(n_bytes: float, ops: float, rate: float) -> Tuple[float, str]:
    """-> (least seconds the card could take, "bytes" or "operations"):
    the bytes each read or written once at the HBM rate, or the operations
    at `rate`, whichever is larger."""
    tb, to = n_bytes / HBM_BYTES_PER_S, ops / rate
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# kernel names (the __global__ functions of medplib_tpu_torch/csrc)
# ---------------------------------------------------------------------------

# __global__ name -> the source that defines it
PORT_KERNELS = {
    "s8_mma_kernel": "csrc/s8_mma.cuh",
    "int4h_mma_kernel": "csrc/int4h_mma.cuh",
    "w8_mma_kernel": "csrc/int8w_mma.cuh",
    "gmm_kernel": "csrc/gmm.cu",
    "moe_prep_kernel": "csrc/moe_decode_int4h.cu",
    "moe_gateup_kernel": "csrc/moe_decode_int4h.cu",
    "moe_act_kernel": "csrc/moe_decode_int4h.cu",
    "moe_down_kernel": "csrc/moe_decode_int4h.cu",
    "moe_combine_kernel": "csrc/moe_decode_int4h.cu",
    "flash_fwd_kernel": "csrc/flash_attention.cu",
    "flash_fwd_mma_kernel": "csrc/flash_attention.cu",
    "flash_dq_kernel": "csrc/flash_attention.cu",
    "flash_dq_mma_kernel": "csrc/flash_attention.cu",
    "flash_dkv_kernel": "csrc/flash_attention.cu",
    "flash_dkv_mma_kernel": "csrc/flash_attention.cu",
    "int8_matmul_kernel": "csrc/int8_matmul.cu",
    "int4h_matmul_f32_kernel": "csrc/int4_matmul.cu",
}

_FIXED = {
    "gmm_kernel": "K3",
    "moe_prep_kernel": "K2", "moe_gateup_kernel": "K2", "moe_act_kernel": "K2",
    "moe_down_kernel": "K2", "moe_combine_kernel": "K2",
    "flash_fwd_kernel": "K4", "flash_fwd_mma_kernel": "K4",
    "flash_dq_kernel": "K5", "flash_dq_mma_kernel": "K5",
    "flash_dkv_kernel": "K6", "flash_dkv_mma_kernel": "K6",
    "int8_matmul_kernel": "K7",
    "int4h_matmul_f32_kernel": "K9",
    # K7 and K3's bf16-x modes share this tile; no argument tells them apart
    "w8_mma_kernel": "K3/K7",
}
# s8_mma_kernel's last template argument, the epilogue (s8_mma.cuh)
_S8_EPILOGUE = {"0": "K8", "kAsWs": "K8", "1": "K3", "kWsAs": "K3",
                "2": "K1", "kHalves": "K1"}
# int4h_mma_kernel's last template argument, bool K1 (int4h_mma.cuh)
_INT4H_K1 = {"true": "K1", "1": "K1", "false": "K9", "0": "K9"}

_NAME_RE = re.compile(r"\b(" + "|".join(sorted(PORT_KERNELS, key=len,
                                                reverse=True)) + r")\b")


class UnmappedKernel(RuntimeError):
    pass


def _template_args(name: str, start: int):
    i = name.find("<", start)
    if i < 0:
        return []
    depth, j, args, cur = 0, i, [], ""
    while j < len(name):
        c = name[j]
        if c == "<":
            depth += 1
            if depth > 1:
                cur += c
        elif c == ">":
            depth -= 1
            if depth == 0:
                args.append(cur.strip())
                return args
            cur += c
        elif c == "," and depth == 1:
            args.append(cur.strip())
            cur = ""
        else:
            cur += c
        j += 1
    return []


def _last_token(arg: str) -> str:
    m = re.search(r"([A-Za-z_0-9]+)\s*$", arg)
    return m.group(1) if m else ""


def kernel_id(name: str) -> Optional[str]:
    """The K-id of a device kernel's (demangled) name; None for a kernel
    that is not the port's. A port kernel whose variant cannot be read
    raises UnmappedKernel, so no time is dropped unseen."""
    m = _NAME_RE.search(name)
    if m is None:
        return None
    base = m.group(1)
    if base in _FIXED:
        return _FIXED[base]
    args = _template_args(name, m.end())
    table = _S8_EPILOGUE if base == "s8_mma_kernel" else _INT4H_K1
    kid = table.get(_last_token(args[-1])) if args else None
    if kid is None:
        raise UnmappedKernel(f"cannot tell which kernel {name!r} is")
    return kid


def by_kernel_id(rows: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """[(name, seconds)] -> {K-id: seconds} over the port's kernels."""
    out: Dict[str, float] = {}
    for name, s in rows:
        kid = kernel_id(name)
        if kid is not None:
            out[kid] = out.get(kid, 0.0) + s
    return out


# ---------------------------------------------------------------------------
# operations a served call needs (2 FLOP a multiply-add)
# ---------------------------------------------------------------------------

def clip_flops(v: dict) -> float:
    """One image through CLIP's patch embedding and the layers up to the
    selected one (select_layer -2: all but the last)."""
    h, m, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n_p = (v["image_size"] // p) ** 2
    t = n_p + 1
    layers = v["num_layers"] + v["select_layer"] + 1 \
        if v["select_layer"] < 0 else v["select_layer"]
    per_layer = 2 * t * 4 * h * h + 2 * 2 * t * t * h + 2 * 2 * t * h * m
    return 2 * n_p * p * p * 3 * h + layers * per_layer


def projector_flops(proj: dict, n_tokens: int, hidden: int) -> float:
    """mlp2x_gelu: mm_hidden -> hidden -> hidden."""
    return 2 * n_tokens * (proj["mm_hidden_size"] * hidden + hidden * hidden)


def sam_encoder_flops(s: dict) -> float:
    """One image through SAM-Med2D's ViT encoder: patch embedding, blocks
    (qkv, windowed or global attention with the decomposed rel-pos terms,
    projection, MLP, adapter with its stride-2 conv and transposed conv),
    neck."""
    c, p, g = s["encoder_embed_dim"], s["patch_size"], \
        s["image_size"] // s["patch_size"]
    t, ws, pd = g * g, s["window_size"], s["prompt_embed_dim"]
    m = int(c * s["mlp_ratio"])
    a = int(c * s["adapter_ratio"])
    total = 2 * t * p * p * 3 * c
    wp = -(-g // ws) * ws                   # grid padded to whole windows
    for i in range(s["encoder_depth"]):
        if i in s["encoder_global_attn_indexes"]:
            n_tok, side, groups = t, g, 1
        else:
            n_tok, side, groups = ws * ws, ws, (wp // ws) ** 2
        attn = groups * (2 * 2 * n_tok * n_tok * c       # scores, values
                         + 2 * n_tok * 2 * side * c)     # rel-pos terms
        lin = 2 * t * c * 3 * c + 2 * t * c * c + 2 * 2 * t * c * m
        half = (g // 2) ** 2
        adapter = (2 * c * a * 2 + 2 * half * 9 * c * c      # conv s2
                   + 2 * half * 16 * c * c)                  # convT k4 s2
        total += attn + lin + adapter
    total += 2 * t * c * pd + 2 * t * 9 * pd * pd
    return total


def sam_decoder_flops(s: dict, n_sparse: int = 1) -> float:
    """One prompt through the two-way transformer, the upscaling and the
    heads (single-mask output)."""
    d, g = s["prompt_embed_dim"], s["image_size"] // s["patch_size"]
    # the iou token, the mask tokens, the sparse prompts
    t_img, nq = g * g, 1 + s["num_multimask_outputs"] + 1 + n_sparse
    di = d // 2

    def attn(nq_, nk, dim, inner):
        return (2 * nq_ * dim * inner + 2 * 2 * nk * dim * inner
                + 2 * 2 * nq_ * nk * inner + 2 * nq_ * inner * dim)

    per_layer = (attn(nq, nq, d, d) + attn(nq, t_img, d, di)
                 + 2 * 2 * nq * d * s["decoder_mlp_dim"]
                 + attn(t_img, nq, d, di))
    total = s["decoder_depth"] * per_layer + attn(nq, t_img, d, di)
    up1 = 2 * t_img * d * (d // 4) * 4
    up2 = 2 * (4 * t_img) * (d // 4) * (d // 8) * 4
    n_mask = s["num_multimask_outputs"] + 1
    hyper = n_mask * 2 * (2 * d * d + d * (d // 8))
    masks = 2 * n_mask * (16 * t_img) * (d // 8)
    iou = 2 * (d * s["iou_head_hidden_dim"]
               + (s["iou_head_depth"] - 2) * s["iou_head_hidden_dim"] ** 2
               + s["iou_head_hidden_dim"] * n_mask)
    return total + up1 + up2 + hyper + masks + iou


def llm_layer_flops(model: dict, n_new: int, pairs: float) -> float:
    """One decoder layer for n_new tokens attending over `pairs` kept
    (query, key) pairs: q/k/v/o, QK^T and PV, the router, one expert's
    SwiGLU (top-1), at the published widths."""
    h, m = model["hidden_size"], model["intermediate_size"]
    hd = model["head_dim"]
    q_dim = model["num_attention_heads"] * hd
    kv_dim = model["num_key_value_heads"] * hd
    e = model["medplib"]["moe"]["num_experts"]
    k = model["medplib"]["moe"]["top_k"]
    proj = 2 * n_new * h * (2 * q_dim + 2 * kv_dim)
    attn = 2 * 2 * pairs * q_dim
    mlp = 2 * n_new * h * e + k * 2 * n_new * 3 * h * m
    return proj + attn + mlp


def serve_call_flops(model: dict, prompt_lens: Iterable[int],
                     new_tokens: int) -> float:
    """A grounded generate call: per row CLIP, the projector, the prefill
    over its real spliced tokens, one lm_head row and the SEG capture at
    the prompt's end, `new_tokens` decode steps (each with its lm_head and
    capture rows), SAM's encoder and one mask decode. prompt_lens: each
    row's spliced prompt length."""
    med = model["medplib"]
    h, L = model["hidden_size"], model["num_hidden_layers"]
    vp, od = med["vocab_size_padded"], med["seg"]["out_dim"]
    n_img = (med["vision"]["image_size"] // med["vision"]["patch_size"]) ** 2
    head = 2 * h * vp
    fcs = 2 * (h * h + h * od)
    per_image = (clip_flops(med["vision"])
                 + projector_flops(med["projector"], n_img, h)
                 + sam_encoder_flops(med["sam"])
                 + sam_decoder_flops(med["sam"]))
    total = 0.0
    for n in prompt_lens:
        total += per_image + L * llm_layer_flops(model, n, n * (n + 1) / 2)
        total += head + 2 * fcs
        for j in range(new_tokens):
            total += L * llm_layer_flops(model, 1, n + j + 1) + head + fcs
    return total


# ---------------------------------------------------------------------------
# per-kernel bounds of the serving cell (PERF.md's kernel table)
# ---------------------------------------------------------------------------

def k1_bound_s(model: dict, rows: int) -> float:
    """K1 over one prefill: per layer gate, up and down over the routed
    rows (every row of the padded batch goes to one expert), W4A8, at the
    int8 peak or the bytes (int8 rows, every expert's int4 weight and
    scales, bf16 out), whichever is larger; the configuration's M."""
    h, m = model["hidden_size"], model["intermediate_size"]
    e = model["medplib"]["moe"]["num_experts"]
    g = model["serving"]["expert_int4_groups"]
    total = 0.0
    for k, n in ((h, m), (h, m), (m, h)):
        ops = 2.0 * rows * k * n
        by = rows * k + e * (k * n // 2 + g * n * 4) + rows * n * 2
        total += bound(by, ops, INT8_OPS)[0]
    return model["num_hidden_layers"] * total


def k2_bound_s(model: dict, rows: int, steps: int) -> float:
    """K2 over `steps` decode steps of `rows` rows: per layer the routed
    experts' int4 weights and scales (min(E, rows) experts: with top-1
    routing at most one expert a row), the rows in and out, at the HBM
    rate (the operations, 2 * rows * 3 * H * M, are far below)."""
    h, m = model["hidden_size"], model["intermediate_size"]
    e = model["medplib"]["moe"]["num_experts"]
    g = model["serving"]["expert_int4_groups"]
    experts = min(e, rows)
    w = experts * (3 * h * m // 2 + g * (2 * m + h) * 4)
    by = w + 2 * rows * h * 2
    ops = 2.0 * rows * 3 * h * m
    return model["num_hidden_layers"] * steps * bound(by, ops, INT8_OPS)[0]


# ---------------------------------------------------------------------------
# the training cell
# ---------------------------------------------------------------------------

def _dense_layer_parts(model: dict, n: int, pairs: float):
    """-> (projections + SwiGLU, the q / v adapters, QK^T + PV) of one
    dense decoder layer's forward over n tokens and `pairs` kept pairs."""
    h, m = model["hidden_size"], model["intermediate_size"]
    hd = model["head_dim"]
    q_dim = model["num_attention_heads"] * hd
    kv_dim = model["num_key_value_heads"] * hd
    r = model["training"]["lora_r"]
    dense = 2 * n * h * (2 * q_dim + 2 * kv_dim) + 2 * n * 3 * h * m
    lora = 2 * n * r * ((h + q_dim) + (h + kv_dim))
    return dense, lora, 2 * 2 * pairs * q_dim


def train_step_flops(model: dict, lens) -> float:
    """The operations one QLoRA step needs over rows of `lens` spliced
    tokens: the forward of CLIP, the projector, the decoder (adapters
    included), lm_head at every position, SAM's encoder and the mask
    decoder; the input gradients back through lm_head and the frozen
    decoder (attention's four backward products twice its two), the
    adapters' and the mask decoder's weight gradients, text_hidden_fcs at
    the <SEG> row (forward, input and weight gradients). Recomputation is
    not counted."""
    med = model["medplib"]
    h, L = model["hidden_size"], model["num_hidden_layers"]
    vp, od = med["vocab_size_padded"], med["seg"]["out_dim"]
    n_img = (med["vision"]["image_size"] // med["vision"]["patch_size"]) ** 2
    per_image = (clip_flops(med["vision"])
                 + projector_flops(med["projector"], n_img, h)
                 + sam_encoder_flops(med["sam"])
                 + 3 * sam_decoder_flops(med["sam"])
                 + 3 * 2 * (h * h + h * od))
    total = 0.0
    for n in lens:
        dense, lora, attn = _dense_layer_parts(model, n, n * (n + 1) / 2)
        fwd = L * (dense + lora + attn)
        bwd = L * (dense + 2 * lora + 2 * attn)
        total += per_image + fwd + bwd + 2 * 2 * n * h * vp
    return total


def flash_step_bound_s(model: dict, lens, padded: int) -> float:
    """K4 + K5 + K6 over one remat step (K4 twice a layer: the forward and
    its recomputation): per launch the kept (query, key) pairs of the
    padded batch (every query row, keys causal and real) at 4·D, 6·D and
    8·D FLOP a pair and head at the bf16 peak, or the bytes (q, k, v, o,
    dO, dQ, dK, dV in bf16; lse and delta in f32), whichever is larger."""
    heads, d = model["num_attention_heads"], model["head_dim"]
    L, b = model["num_hidden_layers"], len(lens)
    pairs = sum(n * (n + 1) / 2 + (padded - n) * n for n in lens)
    tensor = b * padded * heads * d * 2
    rows = b * padded * heads * 4
    fwd = bound(4 * tensor + rows, 4 * d * heads * pairs, BF16_FLOPS)[0]
    dq = bound(6 * tensor + 2 * rows, 6 * d * heads * pairs, BF16_FLOPS)[0]
    dkv = bound(7 * tensor + 2 * rows, 8 * d * heads * pairs,
                BF16_FLOPS)[0]
    return L * (2 * fwd + dq + dkv)
