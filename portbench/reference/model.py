"""Plain float32 MedPLIB on a DeepSeek-LLM / LLaMA decoder: CLIP ViT ->
mlp2x_gelu projector -> splice -> decoder (RMSNorm, RoPE, multi-head
attention, top-1 mixture of SwiGLU experts) -> lm_head; the <SEG> hidden
through text_hidden_fcs into SAM-Med2D (ViT encoder with adapters, prompt
encoder, two-way-transformer mask decoder).

Written from the published architectures with torch operations only; it
imports nothing of the program. Weights come from `portbench.weights` by
key path, so nothing the program made reaches it; the linears that the
configuration stores in int8 / int4 pass through `quant` first. The
decoder runs one layer at a time, drawing that layer's weights, so that it
fits beside what is left on the card. TF32 stays off (set by the caller).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import quant


class Weights:
    """Float32 views of the seeded bf16 weights."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, device

    def __call__(self, path: str, shape, layer: Optional[int] = None):
        return weights.draw(self.seed, path, shape, self.device,
                            layer).float()


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


# ---------------------------------------------------------------------------
# CLIP ViT-L/14 and the projector
# ---------------------------------------------------------------------------

def clip_features(W: Weights, v: dict, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, S, S, 3] -> the selected layer's patch tokens [N, P, h]."""
    h, p, m = v["hidden_size"], v["patch_size"], v["intermediate_size"]
    heads, eps = v["num_heads"], v["layer_norm_eps"]
    n_p = (v["image_size"] // p) ** 2
    kern = W("clip/embeddings/patch_embedding/kernel", (p, p, 3, h))
    x = F.conv2d(pixels.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1),
                 stride=p)
    x = x.flatten(2).transpose(1, 2)                       # [N, P, h]
    cls = W("clip/embeddings/class_embedding", (h,))
    x = torch.cat([cls.expand(x.shape[0], 1, h), x], dim=1)
    x = x + W("clip/embeddings/position_embedding/embedding", (n_p + 1, h))
    x = layer_norm(x, W("clip/pre_layrnorm/weight", (h,)),
                   W("clip/pre_layrnorm/bias", (h,)), eps)
    sl = v["select_layer"]
    n_layers = v["num_layers"] + sl + 1 if sl < 0 else sl
    d = h // heads
    for i in range(n_layers):
        def w(name, shape):
            return W(f"clip/layers/{name}", shape, i)
        y = layer_norm(x, w("layer_norm1/weight", (h,)),
                       w("layer_norm1/bias", (h,)), eps)
        q, k, vv = (y @ w(f"attn/{n}/kernel", (h, h)) + w(f"attn/{n}/bias",
                                                           (h,))
                    for n in ("q_proj", "k_proj", "v_proj"))
        n, t = y.shape[:2]
        q, k, vv = (z.reshape(n, t, heads, d).transpose(1, 2)
                    for z in (q, k, vv))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        o = (att @ vv).transpose(1, 2).reshape(n, t, h)
        x = x + o @ w("attn/out_proj/kernel", (h, h)) \
            + w("attn/out_proj/bias", (h,))
        y = layer_norm(x, w("layer_norm2/weight", (h,)),
                       w("layer_norm2/bias", (h,)), eps)
        y = y @ w("mlp/fc1/kernel", (h, m)) + w("mlp/fc1/bias", (m,))
        y = y * torch.sigmoid(1.702 * y)
        x = x + y @ w("mlp/fc2/kernel", (m, h)) + w("mlp/fc2/bias", (h,))
    return x[:, 1:] if v["select_feature"] == "patch" else x


def projector(W: Weights, model: dict, x: torch.Tensor, bits: int):
    """mlp2x_gelu: linear, exact GELU, linear; kernels stored in `bits`."""
    d_in = model["medplib"]["projector"]["mm_hidden_size"]
    h = model["hidden_size"]
    for i, (a, b) in enumerate(((d_in, h), (h, h))):
        if i:
            x = gelu(x)
        kern = quant.linear_weight(
            W(f"mm_projector/layers/{i}/kernel", (a, b)), 0, bits)
        x = x @ kern + W(f"mm_projector/layers/{i}/bias", (b,))
    return x


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def _rope(x, pos, theta):
    """x [N, heads, T, D], pos [T] -> rotated (half-rotation layout)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).repeat(1, 2), torch.sin(ang).repeat(1, 2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def decoder(W: Weights, model: dict, x: torch.Tensor, lengths: List[int],
            bits: int, rows_per_block: int = 8) -> torch.Tensor:
    """x [N, T, H] (row r real over [0, lengths[r])) -> the final-norm
    hidden states [N, T, H]. Attention and projections in `bits` where the
    configuration stores them in int8."""
    h, L = model["hidden_size"], model["num_hidden_layers"]
    m, eps = model["intermediate_size"], model["rms_norm_eps"]
    heads, d = model["num_attention_heads"], model["head_dim"]
    kvh = model["num_key_value_heads"]
    moe = model["medplib"]["moe"]
    e = moe["num_experts"]
    srv = model["serving"]
    n, t, _ = x.shape
    dev = x.device
    valid = (torch.arange(t, device=dev)[None, :]
             < torch.as_tensor(lengths, device=dev)[:, None])
    pos = torch.arange(t, device=dev)
    causal = pos[None, :] <= pos[:, None]
    for i in range(L):
        def w(name, shape):
            return W(f"llm/layers/{name}", shape, i)
        qw, kw, vw = (quant.linear_weight(w(f"attn/{p}/kernel", (o, h)), 1,
                                          bits)
                      for p, o in (("q_proj", heads * d),
                                   ("k_proj", kvh * d), ("v_proj", kvh * d)))
        ow = quant.linear_weight(w("attn/o_proj/kernel", (heads * d, h)), 0,
                                 bits)
        ln1 = w("input_layernorm/weight", (h,))
        for r0 in range(0, n, rows_per_block):
            xb = x[r0:r0 + rows_per_block]
            nb = xb.shape[0]
            y = rms_norm(xb, ln1, eps)
            q = (y @ qw.t()).reshape(nb, t, heads, d).transpose(1, 2)
            k = (y @ kw.t()).reshape(nb, t, kvh, d).transpose(1, 2)
            v = (y @ vw.t()).reshape(nb, t, kvh, d).transpose(1, 2)
            q, k = _rope(q, pos, model["rope_theta"]), \
                _rope(k, pos, model["rope_theta"])
            if kvh != heads:
                k = k.repeat_interleave(heads // kvh, dim=1)
                v = v.repeat_interleave(heads // kvh, dim=1)
            s = q @ k.transpose(-1, -2) / math.sqrt(d)
            keep = causal[None, None] & valid[r0:r0 + nb, None, None, :]
            s = s.masked_fill(~keep, float("-inf"))
            o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2)
            x[r0:r0 + nb] = xb + o.reshape(nb, t, heads * d) @ ow
            del q, k, v, s, o, y
        del qw, kw, vw, ow
        router = w("moe/router/kernel", (h, e))
        shapes = {"gate_proj": (e, h, m), "up_proj": (e, h, m),
                  "down_proj": (e, m, h)}
        ex = {p: quant.padded_experts(
                  w(f"moe/experts/{p}/kernel", s), 1 if p == "down_proj"
                  else 2, srv["expert_pad_align"],
                  srv["expert_int4_groups"])
              for p, s in shapes.items()}
        ln2 = w("post_attention_layernorm/weight", (h,))
        xs = x[valid]                                   # [tokens, H]
        y = rms_norm(xs, ln2, eps)
        probs = torch.softmax(y @ router, dim=-1)
        gate, idx = probs.max(dim=-1)                   # top-1, first max
        out = torch.zeros_like(xs)
        for j in range(e):
            sel = idx == j
            yj = y[sel]
            g = yj @ ex["gate_proj"][j]
            a = g * torch.sigmoid(g) * (yj @ ex["up_proj"][j])
            out[sel] = gate[sel, None] * (a @ ex["down_proj"][j])
        x[valid] = xs + out
        del ex, y, out, xs
    return rms_norm(x, W("llm/norm/weight", (h,)), eps)


def lm_head(W: Weights, model: dict, hidden: torch.Tensor, bits: int):
    h, vp = model["hidden_size"], model["medplib"]["vocab_size_padded"]
    kern = quant.linear_weight(W("llm/lm_head/kernel", (h, vp)), 0, bits)
    return hidden @ kern


def text_hidden_fcs(W: Weights, model: dict, hidden: torch.Tensor):
    h, od = model["hidden_size"], model["medplib"]["seg"]["out_dim"]
    y = torch.relu(hidden @ W("text_hidden_fcs/fc1/kernel", (h, h))
                   + W("text_hidden_fcs/fc1/bias", (h,)))
    return y @ W("text_hidden_fcs/fc2/kernel", (h, od)) \
        + W("text_hidden_fcs/fc2/bias", (od,))


# ---------------------------------------------------------------------------
# SAM-Med2D
# ---------------------------------------------------------------------------

def _conv_hwio(x, k, stride=1, padding=0):
    """x [N, C, H, W]; k [kh, kw, Cin, Cout]."""
    return F.conv2d(x, k.permute(3, 2, 0, 1), stride=stride, padding=padding)


def _ln_channels(x, w, b, eps):
    """LayerNorm over the channel axis of [N, C, H, W]."""
    return layer_norm(x.permute(0, 2, 3, 1), w, b, eps).permute(0, 3, 1, 2)


def _sam_attention(W, i, x, s):
    """x [N, h, w, C] (a window or the whole grid) -> [N, h, w, C]."""
    n, hh, ww, c = x.shape
    heads = s["encoder_num_heads"]
    d = c // heads
    g = s["image_size"] // s["patch_size"]
    max_rel = 2 * max(s["window_size"], g) - 1

    def w(name, shape):
        return W(f"sam/image_encoder/blocks/attn/{name}", shape, i)
    qkv = x.reshape(n, hh * ww, c) @ w("qkv/kernel", (c, 3 * c)) \
        + w("qkv/bias", (3 * c,))
    qkv = qkv.reshape(n, hh * ww, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                 # [N, heads, T, d]
    s_ = (q / math.sqrt(d)) @ k.transpose(-1, -2)
    rel_h, rel_w = w("rel_pos_h", (max_rel, d)), w("rel_pos_w", (max_rel, d))
    ih = torch.arange(hh, device=x.device)
    iw = torch.arange(ww, device=x.device)
    rh = rel_h[(ih[:, None] - ih[None, :]) + hh - 1]       # [h, h, d]
    rw = rel_w[(iw[:, None] - iw[None, :]) + ww - 1]       # [w, w, d]
    qg = q.reshape(n, heads, hh, ww, d)
    bh = torch.einsum("nahwc,hkc->nahwk", qg, rh)
    bw = torch.einsum("nahwc,wkc->nahwk", qg, rw)
    bias = bh[..., :, None] + bw[..., None, :]             # [.., h, w, h, w]
    s_ = s_ + bias.reshape(n, heads, hh * ww, hh * ww)
    o = torch.softmax(s_, dim=-1) @ v
    o = o.transpose(1, 2).reshape(n, hh, ww, c)
    return o @ w("proj/kernel", (c, c)) + w("proj/bias", (c,))


def sam_image(W: Weights, s: dict, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, S, S, 3] -> image embeddings [N, g, g, D]."""
    c, p, ws = s["encoder_embed_dim"], s["patch_size"], s["window_size"]
    g, pd = s["image_size"] // p, s["prompt_embed_dim"]
    eps = s["layer_norm_eps"]
    mh = int(c * s["mlp_ratio"])
    ah = int(c * s["adapter_ratio"])
    x = _conv_hwio(pixels.permute(0, 3, 1, 2),
                   W("sam/image_encoder/patch_embed/kernel", (p, p, 3, c)),
                   stride=p).permute(0, 2, 3, 1)
    x = x + W("sam/image_encoder/patch_embed/bias", (c,))
    x = x + W("sam/image_encoder/pos_embed", (1, g, g, c))
    n = x.shape[0]
    for i in range(s["encoder_depth"]):
        def w(name, shape):
            return W(f"sam/image_encoder/blocks/{name}", shape, i)
        y = layer_norm(x, w("norm1/weight", (c,)), w("norm1/bias", (c,)), eps)
        if i in s["encoder_global_attn_indexes"]:
            y = _sam_attention(W, i, y, s)
        else:
            hp = -(-g // ws) * ws
            yp = F.pad(y, (0, 0, 0, hp - g, 0, hp - g))
            nw = hp // ws
            yp = yp.reshape(n, nw, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
            yp = _sam_attention(W, i, yp.reshape(-1, ws, ws, c), s)
            yp = yp.reshape(n, nw, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
            y = yp.reshape(n, hp, hp, c)[:, :g, :g]
        x = x + y
        xn = layer_norm(x, w("norm2/weight", (c,)), w("norm2/bias", (c,)),
                        eps)
        mlp = gelu(xn @ w("mlp/lin1/kernel", (c, mh))
                   + w("mlp/lin1/bias", (mh,)))
        mlp = mlp @ w("mlp/lin2/kernel", (mh, c)) + w("mlp/lin2/bias", (c,))
        # adapter: channel gate, stride-2 conv, transposed conv, skip, LN
        gate = torch.relu(xn.mean(dim=(1, 2))
                          @ w("adapter/channel_fc1/kernel", (c, ah)))
        gate = torch.sigmoid(gate @ w("adapter/channel_fc2/kernel", (ah, c)))
        xc = (xn * gate[:, None, None, :]).permute(0, 3, 1, 2)
        sp = torch.relu(_conv_hwio(
            xc, w("adapter/spatial_conv/kernel", (3, 3, c, c)), 2, 1))
        sp = torch.relu(F.conv_transpose2d(
            sp, w("adapter/spatial_convt/kernel", (c, c, 4, 4)), stride=2,
            padding=1)).permute(0, 2, 3, 1)
        ad = layer_norm(xn + sp, w("adapter/norm/weight", (c,)),
                        w("adapter/norm/bias", (c,)), 1e-6)
        x = x + mlp + ad
    neck = "sam/image_encoder/neck/"
    y = _conv_hwio(x.permute(0, 3, 1, 2), W(neck + "conv1/kernel",
                                            (1, 1, c, pd)))
    y = _ln_channels(y, W(neck + "ln1/weight", (pd,)),
                     W(neck + "ln1/bias", (pd,)), 1e-6)
    y = _conv_hwio(y, W(neck + "conv2/kernel", (3, 3, pd, pd)), padding=1)
    y = _ln_channels(y, W(neck + "ln2/weight", (pd,)),
                     W(neck + "ln2/bias", (pd,)), 1e-6)
    return y.permute(0, 2, 3, 1)


def _dec_attention(W, prefix, q, k, v, heads, dim, inner):
    def lin(name, x, a, b):
        return x @ W(f"{prefix}/{name}/kernel", (a, b)) \
            + W(f"{prefix}/{name}/bias", (b,))
    q, k, v = (lin(nm, z, dim, inner) for nm, z in
               (("q_proj", q), ("k_proj", k), ("v_proj", v)))
    n, nq, _ = q.shape
    d = inner // heads
    q = q.reshape(n, nq, heads, d).transpose(1, 2)
    k = k.reshape(n, -1, heads, d).transpose(1, 2)
    v = v.reshape(n, -1, heads, d).transpose(1, 2)
    o = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1) @ v
    return lin("out_proj", o.transpose(1, 2).reshape(n, nq, inner), inner,
               dim)


def sam_mask(W: Weights, s: dict, image_emb: torch.Tensor,
             text_emb: torch.Tensor) -> torch.Tensor:
    """image_emb [N, g, g, D], one text prompt [N, D] each -> the first
    mask's logits [N, S, S] at the input size."""
    pd, g = s["prompt_embed_dim"], s["image_size"] // s["patch_size"]
    heads, n_mask = s["decoder_num_heads"], s["num_multimask_outputs"] + 1
    n = image_emb.shape[0]
    md, pe = "sam/mask_decoder", "sam/prompt_encoder"
    gauss = W(f"{pe}/pe_layer/gaussian_matrix", (2, pd // 2))
    centers = (torch.arange(g, device=image_emb.device,
                            dtype=torch.float32) + 0.5) / g
    yy, xx = torch.meshgrid(centers, centers, indexing="ij")
    coords = torch.stack([xx, yy], dim=-1)                 # (x, y)
    c = 2 * math.pi * ((2 * coords - 1) @ gauss)
    image_pe = torch.cat([torch.sin(c), torch.cos(c)], dim=-1)
    pos = image_pe.reshape(1, g * g, pd).expand(n, -1, -1)
    tokens = torch.cat([W(f"{md}/iou_token", (1, pd)),
                        W(f"{md}/mask_tokens", (n_mask, pd))], dim=0)
    tokens = torch.cat([tokens[None].expand(n, -1, -1), text_emb[:, None]],
                       dim=1)
    keys = (image_emb + W(f"{pe}/no_mask_embed", (pd,))).reshape(n, g * g,
                                                                 pd)
    queries = tokens
    tr = f"{md}/transformer"

    def ln(name, x):
        return layer_norm(x, W(f"{name}/weight", (pd,)),
                          W(f"{name}/bias", (pd,)), 1e-5)
    for li in range(s["decoder_depth"]):
        lp = f"{tr}/layers/{li}"
        if li == 0:
            queries = _dec_attention(W, f"{lp}/self_attn", queries, queries,
                                     queries, heads, pd, pd)
        else:
            qq = queries + tokens
            queries = queries + _dec_attention(W, f"{lp}/self_attn", qq, qq,
                                               queries, heads, pd, pd)
        queries = ln(f"{lp}/norm1", queries)
        queries = queries + _dec_attention(
            W, f"{lp}/cross_attn_token_to_image", queries + tokens,
            keys + pos, keys, heads, pd, pd // 2)
        queries = ln(f"{lp}/norm2", queries)
        mlp = torch.relu(queries @ W(f"{lp}/mlp/lin1/kernel",
                                     (pd, s["decoder_mlp_dim"]))
                         + W(f"{lp}/mlp/lin1/bias", (s["decoder_mlp_dim"],)))
        mlp = mlp @ W(f"{lp}/mlp/lin2/kernel", (s["decoder_mlp_dim"], pd)) \
            + W(f"{lp}/mlp/lin2/bias", (pd,))
        queries = ln(f"{lp}/norm3", queries + mlp)
        keys = keys + _dec_attention(
            W, f"{lp}/cross_attn_image_to_token", keys + pos,
            queries + tokens, queries, heads, pd, pd // 2)
        keys = ln(f"{lp}/norm4", keys)
    queries = queries + _dec_attention(
        W, f"{tr}/final_attn_token_to_image", queries + tokens, keys + pos,
        keys, heads, pd, pd // 2)
    queries = ln(f"{tr}/norm_final_attn", queries)
    up = f"{md}/output_upscaling"
    x = keys.transpose(1, 2).reshape(n, pd, g, g)
    x = F.conv_transpose2d(x, W(f"{up}/convt1/kernel", (pd, pd // 4, 2, 2)),
                           W(f"{up}/convt1/bias", (pd // 4,)), stride=2)
    x = gelu(_ln_channels(x, W(f"{up}/ln/weight", (pd // 4,)),
                          W(f"{up}/ln/bias", (pd // 4,)), 1e-6))
    x = gelu(F.conv_transpose2d(
        x, W(f"{up}/convt2/kernel", (pd // 4, pd // 8, 2, 2)),
        W(f"{up}/convt2/bias", (pd // 8,)), stride=2))     # [N, D/8, 4g, 4g]
    hyper = queries[:, 1]                                  # mask token 0
    dims = ((pd, pd), (pd, pd), (pd, pd // 8))
    for j, (a, b) in enumerate(dims):
        hyper = hyper @ W(f"{md}/output_hypernetworks_mlps/0/{j}/kernel",
                          (a, b)) \
            + W(f"{md}/output_hypernetworks_mlps/0/{j}/bias", (b,))
        if j < len(dims) - 1:
            hyper = torch.relu(hyper)
    low = torch.einsum("nc,nchw->nhw", hyper, x)
    return F.interpolate(low[:, None], size=(s["image_size"],) * 2,
                         mode="bilinear", align_corners=False)[:, 0]


def embedding_table(W: Weights, model: dict) -> torch.Tensor:
    """The token embedding table as stored (bf16): rows are taken from it
    and widened to float32 one prompt at a time."""
    h, vp = model["hidden_size"], model["medplib"]["vocab_size_padded"]
    return weights.draw(W.seed, "llm/embed_tokens/embedding", (vp, h),
                        W.device)

