"""SAM-Med2D (ViT-B @256, adapter-tuned): image encoder, prompt encoder
(text embeddings, points, boxes and a low-res mask) and two-way-transformer
mask decoder (medplib_tpu/models/sam_med2d.py).

Public tensors are NHWC as in the JAX package; convolutions permute to
NCHW inside. Kernel layouts are the JAX tree's: convolutions HWIO (read as
OIHW via a permute), transposed convolutions in torch's [Cin, Cout, kh, kw]
(conv_transpose2d directly: the adapter's k4 s2 p1, the upscaling k2 s2
p0). The MedPLIB SEG path prompts with text embeddings only; points,
boxes and masks serve the predictor (models/sam_predictor.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import SamConfig
from medplib_tpu_torch.models.llama import layer_params
from medplib_tpu_torch.ops.initializers import dense_init, normal
from medplib_tpu_torch.ops.norms import layer_norm
from medplib_tpu_torch.utils import profiling

Params = Dict[str, Any]


def _gelu(x):
    return F.gelu(x, approximate="none")


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1,
          padding: int = 0, bias: Optional[torch.Tensor] = None):
    """NHWC x, HWIO kernel -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def _convt(x: torch.Tensor, w_torch: torch.Tensor, stride: int, padding: int,
           bias: Optional[torch.Tensor] = None):
    """NHWC x, torch ConvTranspose2d kernel [Cin, Cout, kh, kw] -> NHWC."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w_torch, stride=stride,
                           padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_sam(gen: torch.Generator, cfg: SamConfig, dtype=torch.float32,
             device="cuda") -> Params:
    def lin(din, dout, bias=True, lead=()):
        d = {"kernel": dense_init(gen, din, dout, dtype, device, lead)}
        if bias:
            d["bias"] = torch.zeros(tuple(lead) + (dout,), dtype=dtype,
                                    device=device)
        return d

    def ln(dim, lead=()):
        shape = tuple(lead) + (dim,)
        return {"weight": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}

    def conv(kh, kw, cin, cout, bias=True, torch_layout=False, lead=()):
        shape = (cin, cout, kh, kw) if torch_layout else (kh, kw, cin, cout)
        d = {"kernel": normal(gen, tuple(lead) + shape, dtype, device,
                              (kh * kw * cin) ** -0.5)}
        if bias:
            d["bias"] = torch.zeros(tuple(lead) + (cout,), dtype=dtype,
                                    device=device)
        return d

    e = cfg.encoder_embed_dim
    d_head = e // cfg.encoder_num_heads
    grid = cfg.image_embedding_size
    D = (cfg.encoder_depth,)
    max_rel = 2 * max(cfg.window_size, grid) - 1
    blocks = {
        "norm1": ln(e, D),
        "attn": {"qkv": lin(e, 3 * e, lead=D), "proj": lin(e, e, lead=D),
                 "rel_pos_h": torch.zeros(D + (max_rel, d_head), dtype=dtype,
                                          device=device),
                 "rel_pos_w": torch.zeros(D + (max_rel, d_head), dtype=dtype,
                                          device=device)},
        "norm2": ln(e, D),
        "mlp": {"lin1": lin(e, int(e * cfg.mlp_ratio), lead=D),
                "lin2": lin(int(e * cfg.mlp_ratio), e, lead=D)},
    }
    if cfg.use_adapter:
        hid = int(e * cfg.adapter_ratio)
        blocks["adapter"] = {
            "channel_fc1": lin(e, hid, bias=False, lead=D),
            "channel_fc2": lin(hid, e, bias=False, lead=D),
            "spatial_conv": conv(3, 3, e, e, bias=False, lead=D),
            "spatial_convt": conv(4, 4, e, e, bias=False, torch_layout=True,
                                  lead=D),
            "norm": ln(e, D),
        }
    pd = cfg.prompt_embed_dim
    enc = {
        "patch_embed": conv(cfg.patch_size, cfg.patch_size, 3, e),
        "pos_embed": torch.zeros((1, grid, grid, e), dtype=dtype,
                                 device=device),
        "blocks": blocks,
        "neck": {"conv1": conv(1, 1, e, pd, bias=False), "ln1": ln(pd),
                 "conv2": conv(3, 3, pd, pd, bias=False), "ln2": ln(pd)},
    }
    mc = cfg.mask_in_chans
    pe = {
        "pe_layer": {"gaussian_matrix": normal(gen, (2, pd // 2), dtype,
                                               device)},
        "point_embeddings": normal(gen, (4, pd), dtype, device, 0.02),
        "not_a_point_embed": torch.zeros((pd,), dtype=dtype, device=device),
        "no_mask_embed": torch.zeros((pd,), dtype=dtype, device=device),
        "mask_downscaling": {
            "conv1": conv(2, 2, 1, mc // 4), "ln1": ln(mc // 4),
            "conv2": conv(2, 2, mc // 4, mc), "ln2": ln(mc),
            "conv3": conv(1, 1, mc, pd)},
    }
    n_mask = cfg.num_multimask_outputs + 1

    def attn_block(inner):
        return {"q_proj": lin(pd, inner), "k_proj": lin(pd, inner),
                "v_proj": lin(pd, inner), "out_proj": lin(inner, pd)}

    layers = [{
        "self_attn": attn_block(pd), "norm1": ln(pd),
        "cross_attn_token_to_image": attn_block(pd // 2), "norm2": ln(pd),
        "mlp": {"lin1": lin(pd, cfg.decoder_mlp_dim),
                "lin2": lin(cfg.decoder_mlp_dim, pd)},
        "norm3": ln(pd),
        "cross_attn_image_to_token": attn_block(pd // 2), "norm4": ln(pd),
    } for _ in range(cfg.decoder_depth)]
    hid = cfg.iou_head_hidden_dim
    md = {
        "iou_token": normal(gen, (1, pd), dtype, device, 0.02),
        "mask_tokens": normal(gen, (n_mask, pd), dtype, device, 0.02),
        "transformer": {"layers": layers,
                        "final_attn_token_to_image": attn_block(pd // 2),
                        "norm_final_attn": ln(pd)},
        "output_upscaling": {
            "convt1": conv(2, 2, pd, pd // 4, torch_layout=True),
            "ln": ln(pd // 4),
            "convt2": conv(2, 2, pd // 4, pd // 8, torch_layout=True)},
        "output_hypernetworks_mlps": [
            [lin(pd, pd), lin(pd, pd), lin(pd, pd // 8)]
            for _ in range(n_mask)],
        "iou_prediction_head": ([lin(pd, hid)]
                                + [lin(hid, hid)
                                   for _ in range(cfg.iou_head_depth - 2)]
                                + [lin(hid, n_mask)]),
    }
    return {"image_encoder": enc, "prompt_encoder": pe, "mask_decoder": md}


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def _window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> [B*nW, ws, ws, C], padding H/W to multiples of ws."""
    b, h, w, c = x.shape
    pad_h, pad_w = -h % ws, -w % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def _window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _rel_pos_bias(q_hw: Tuple[int, int], rel_pos_h: torch.Tensor,
                  rel_pos_w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Decomposed rel-pos bias. q [B*heads, H, W, d] -> [B*heads, HW, HW]."""
    h, w = q_hw
    dev = q.device
    idx_h = torch.as_tensor(np.arange(h)[:, None] - np.arange(h)[None, :]
                            + (h - 1), device=dev)
    idx_w = torch.as_tensor(np.arange(w)[:, None] - np.arange(w)[None, :]
                            + (w - 1), device=dev)
    rh = rel_pos_h[idx_h].to(q.dtype)                 # [h, h, d]
    rw = rel_pos_w[idx_w].to(q.dtype)                 # [w, w, d]
    rel_h = torch.einsum("bhwc,hkc->bhwk", q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", q, rw)
    bias = rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return bias.reshape(q.shape[0], h * w, h * w)


def _encoder_attention(p: Params, x: torch.Tensor, num_heads: int,
                       use_rel_pos: bool) -> torch.Tensor:
    """x [B, H, W, C] (windowed or global grid)."""
    b, h, w, c = x.shape
    d = c // num_heads
    qkv = x.reshape(b, h * w, c) @ p["qkv"]["kernel"] + p["qkv"]["bias"]
    qkv = qkv.reshape(b, h * w, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = (t.reshape(b * num_heads, h * w, d) for t in qkv)
    logits = torch.einsum("bqd,bkd->bqk", (q * d ** -0.5).float(), k.float())
    if use_rel_pos:
        logits = logits + _rel_pos_bias(
            (h, w), p["rel_pos_h"], p["rel_pos_w"],
            q.reshape(b * num_heads, h, w, d).float())
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bqk,bkd->bqd", probs, v)
    out = out.reshape(b, num_heads, h, w, d).permute(0, 2, 3, 1, 4)
    out = out.reshape(b, h, w, c)
    return out @ p["proj"]["kernel"] + p["proj"]["bias"]


def _adapter(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SE channel gate -> conv / convT spatial refinement -> skip -> LN."""
    pooled = x.mean(dim=(1, 2))
    gate = torch.relu(pooled @ p["channel_fc1"]["kernel"])
    gate = torch.sigmoid(gate @ p["channel_fc2"]["kernel"])
    xc = x * gate[:, None, None, :]
    s = torch.relu(_conv(xc, p["spatial_conv"]["kernel"], stride=2,
                         padding=1))
    s = torch.relu(_convt(s, p["spatial_convt"]["kernel"], stride=2,
                          padding=1))
    return layer_norm(x + s, p["norm"]["weight"], p["norm"]["bias"], 1e-6)


def _encoder_block(p: Params, x: torch.Tensor, cfg: SamConfig,
                   window_size: int) -> torch.Tensor:
    shortcut = x
    x = layer_norm(x, p["norm1"]["weight"], p["norm1"]["bias"],
                   cfg.layer_norm_eps)
    if window_size > 0:
        hw = x.shape[1:3]
        x, pad_hw = _window_partition(x, window_size)
    x = _encoder_attention(p["attn"], x, cfg.encoder_num_heads,
                           cfg.use_rel_pos)
    if window_size > 0:
        x = _window_unpartition(x, window_size, pad_hw, hw)
    x = shortcut + x
    xn = layer_norm(x, p["norm2"]["weight"], p["norm2"]["bias"],
                    cfg.layer_norm_eps)
    mlp = _gelu(xn @ p["mlp"]["lin1"]["kernel"] + p["mlp"]["lin1"]["bias"])
    mlp = mlp @ p["mlp"]["lin2"]["kernel"] + p["mlp"]["lin2"]["bias"]
    if cfg.use_adapter:
        return x + mlp + _adapter(p["adapter"], xn)
    return x + mlp


@profiling.span("sam.encode")
def encode_image(params: Params, images: torch.Tensor,
                 cfg: SamConfig) -> torch.Tensor:
    """images [B, H, W, 3] -> image embeddings [B, h, w, 256]."""
    images = images.to(params["patch_embed"]["kernel"].dtype)
    x = _conv(images, params["patch_embed"]["kernel"], stride=cfg.patch_size,
              bias=params["patch_embed"]["bias"])
    x = x + params["pos_embed"]
    for i in range(cfg.encoder_depth):
        ws = 0 if i in cfg.encoder_global_attn_indexes else cfg.window_size
        x = _encoder_block(layer_params(params["blocks"], i), x, cfg, ws)
    n = params["neck"]
    x = _conv(x, n["conv1"]["kernel"])
    x = layer_norm(x, n["ln1"]["weight"], n["ln1"]["bias"], 1e-6)
    x = _conv(x, n["conv2"]["kernel"], padding=1)
    return layer_norm(x, n["ln2"]["weight"], n["ln2"]["bias"], 1e-6)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def _pe_encoding(gaussian: torch.Tensor, coords01: torch.Tensor):
    """coords in [0,1]^2, last dim (x, y) -> [..., 2*num_feats]."""
    c = (2.0 * coords01 - 1.0) @ gaussian.float()
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(params: Params, cfg: SamConfig) -> torch.Tensor:
    """Positional grid for the image embedding -> [h, w, embed_dim] f32."""
    h = w = cfg.image_embedding_size
    g = params["pe_layer"]["gaussian_matrix"]
    y = (torch.arange(h, dtype=torch.float32, device=g.device) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=g.device) + 0.5) / w
    grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return _pe_encoding(g, grid)


def preprocess_pixels(images_rgb: torch.Tensor,
                      cfg: SamConfig) -> torch.Tensor:
    """[B, H, W, 3] uint8 / float RGB -> normalized f32."""
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32,
                        device=images_rgb.device)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32,
                       device=images_rgb.device)
    return (images_rgb.float() - mean) / std


def _size(cfg: SamConfig, device) -> torch.Tensor:
    """The input side as a device tensor: a true division on every device
    (CUDA turns a Python-number divisor into a reciprocal multiply)."""
    return torch.tensor(float(cfg.image_size), device=device)


def embed_points(params: Params, cfg: SamConfig, coords: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """coords [B, N, 2] in input-image pixels (x, y); labels [B, N] in
    {-1: pad, 0: negative, 1: positive} -> [B, N, embed_dim] f32."""
    c01 = (coords.float() + 0.5) / _size(cfg, coords.device)
    pe = _pe_encoding(params["pe_layer"]["gaussian_matrix"], c01)
    pts = params["point_embeddings"]
    pad = (labels == -1)[..., None]
    pe = torch.where(pad, torch.zeros_like(pe), pe)
    for hit, emb in ((pad, params["not_a_point_embed"]),
                     ((labels == 0)[..., None], pts[0]),
                     ((labels == 1)[..., None], pts[1])):
        pe = pe + torch.where(hit, emb[None, None],
                              torch.zeros((), dtype=emb.dtype,
                                          device=emb.device))
    return pe


def embed_boxes(params: Params, cfg: SamConfig,
                boxes: torch.Tensor) -> torch.Tensor:
    """boxes [B, 4] (x0, y0, x1, y1) -> corner embeddings [B, 2, D] f32."""
    corners = (boxes.float().reshape(-1, 2, 2) + 0.5) / _size(cfg,
                                                              boxes.device)
    pe = _pe_encoding(params["pe_layer"]["gaussian_matrix"], corners)
    pts = params["point_embeddings"]
    return torch.stack([pe[:, 0] + pts[2], pe[:, 1] + pts[3]], dim=1)


def embed_mask_input(params: Params, masks: torch.Tensor) -> torch.Tensor:
    """masks [B, 4h, 4w, 1] -> dense embedding [B, h, w, embed_dim]:
    conv k2 s2 -> LN -> GELU -> conv k2 s2 -> LN -> GELU -> conv 1x1."""
    p = params["mask_downscaling"]
    x = masks.to(p["conv1"]["kernel"].dtype)
    x = _conv(x, p["conv1"]["kernel"], stride=2, bias=p["conv1"]["bias"])
    x = _gelu(layer_norm(x, p["ln1"]["weight"], p["ln1"]["bias"], 1e-6))
    x = _conv(x, p["conv2"]["kernel"], stride=2, bias=p["conv2"]["bias"])
    x = _gelu(layer_norm(x, p["ln2"]["weight"], p["ln2"]["bias"], 1e-6))
    return _conv(x, p["conv3"]["kernel"], bias=p["conv3"]["bias"])


def encode_prompts(params: Params, cfg: SamConfig, batch: int,
                   points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   boxes: Optional[torch.Tensor] = None,
                   mask_input: Optional[torch.Tensor] = None,
                   text_embeds: Optional[torch.Tensor] = None):
    """-> (sparse [B, N, D], dense [B, h, w, D]). Sparse prompts in the
    order points (with a not-a-point pad slot when there is no box),
    box corners, text embeddings; the dense prompt is the downscaled
    mask_input or the no-mask embedding. The SEG path passes only
    text_embeds [B, 1, D]."""
    parts = []
    if points is not None:
        coords, labels = points
        if boxes is None:  # pad with a not-a-point slot
            coords = torch.cat([coords, torch.zeros_like(coords[:, :1])],
                               dim=1)
            labels = torch.cat([labels, -torch.ones_like(labels[:, :1])],
                               dim=1)
        parts.append(embed_points(params, cfg, coords, labels))
    if boxes is not None:
        parts.append(embed_boxes(params, cfg, boxes))
    if text_embeds is not None:
        parts.append(text_embeds)
    if len(parts) > 1:
        sparse = torch.cat(parts, dim=1)
    elif parts:
        sparse = parts[0]
    else:
        sparse = params["no_mask_embed"].new_zeros(
            (batch, 0, cfg.prompt_embed_dim), dtype=torch.float32)
    if mask_input is not None:
        dense = embed_mask_input(params, mask_input)
    else:
        s = cfg.image_embedding_size
        dense = params["no_mask_embed"][None, None, None].expand(
            batch, s, s, cfg.prompt_embed_dim)
    return sparse, dense


# ---------------------------------------------------------------------------
# two-way transformer mask decoder
# ---------------------------------------------------------------------------

def _decoder_attention(p: Params, q, k, v, num_heads: int):
    def proj(name, x):
        return x @ p[name]["kernel"] + p[name]["bias"]

    q, k, v = proj("q_proj", q), proj("k_proj", k), proj("v_proj", v)
    b, nq, c = q.shape
    d = c // num_heads
    q = q.reshape(b, nq, num_heads, d)
    k = k.reshape(b, -1, num_heads, d)
    v = v.reshape(b, -1, num_heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, nq, c)
    return out @ p["out_proj"]["kernel"] + p["out_proj"]["bias"]


def _ln(p, x, eps=1e-5):
    return layer_norm(x, p["weight"], p["bias"], eps)


def two_way_transformer(p: Params, image_embedding: torch.Tensor,
                        image_pe: torch.Tensor, point_embedding: torch.Tensor,
                        cfg: SamConfig):
    """image_embedding/image_pe [B, h*w, D]; point_embedding [B, N, D]
    -> (queries [B, N, D], keys [B, h*w, D])."""
    nh = cfg.decoder_num_heads
    queries, keys = point_embedding, image_embedding
    for i, lp in enumerate(p["layers"]):
        if i == 0:
            queries = _decoder_attention(lp["self_attn"], queries, queries,
                                         queries, nh)
        else:
            q = queries + point_embedding
            queries = queries + _decoder_attention(lp["self_attn"], q, q,
                                                   queries, nh)
        queries = _ln(lp["norm1"], queries)
        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + _decoder_attention(
            lp["cross_attn_token_to_image"], q, k, keys, nh)
        queries = _ln(lp["norm2"], queries)
        mlp = torch.relu(queries @ lp["mlp"]["lin1"]["kernel"]
                         + lp["mlp"]["lin1"]["bias"])
        mlp = mlp @ lp["mlp"]["lin2"]["kernel"] + lp["mlp"]["lin2"]["bias"]
        queries = _ln(lp["norm3"], queries + mlp)
        q = queries + point_embedding
        k = keys + image_pe
        keys = keys + _decoder_attention(
            lp["cross_attn_image_to_token"], k, q, queries, nh)
        keys = _ln(lp["norm4"], keys)
    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + _decoder_attention(p["final_attn_token_to_image"], q,
                                           k, keys, nh)
    return _ln(p["norm_final_attn"], queries), keys


def _mlp(layers, x):
    for i, lin in enumerate(layers):
        x = x @ lin["kernel"] + lin["bias"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def decode_masks(params: Params, cfg: SamConfig,
                 image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                 sparse_prompts: torch.Tensor, dense_prompts: torch.Tensor,
                 multimask_output: bool = False):
    """-> (low-res mask logits [B, M, 4h, 4w], iou predictions [B, M]),
    batched over every prompt in B. Runs in the weight dtype."""
    p = params
    b = sparse_prompts.shape[0]
    n_mask = cfg.num_multimask_outputs + 1
    wdtype = p["iou_token"].dtype
    image_pe = image_pe.to(wdtype)
    output_tokens = torch.cat([p["iou_token"], p["mask_tokens"]], dim=0)
    tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                        sparse_prompts.to(wdtype)], dim=1)
    h, w = image_embeddings.shape[1:3]
    src = (image_embeddings.to(wdtype) + dense_prompts.to(wdtype)).reshape(
        b, h * w, -1)
    pos = image_pe.reshape(1, h * w, -1).expand(b, -1, -1)
    hs, src = two_way_transformer(p["transformer"], src, pos, tokens, cfg)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + n_mask]

    up = p["output_upscaling"]
    x = _convt(src.reshape(b, h, w, -1), up["convt1"]["kernel"], 2, 0,
               up["convt1"]["bias"])
    x = _gelu(layer_norm(x, up["ln"]["weight"], up["ln"]["bias"], 1e-6))
    upscaled = _gelu(_convt(x, up["convt2"]["kernel"], 2, 0,
                            up["convt2"]["bias"]))       # [B, 4h, 4w, D/8]
    hyper = torch.stack([_mlp(p["output_hypernetworks_mlps"][i],
                              mask_tokens_out[:, i]) for i in range(n_mask)],
                        dim=1)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, upscaled)
    iou_pred = _mlp(p["iou_prediction_head"], iou_token_out)
    if multimask_output:
        return masks[:, 1:], iou_pred[:, 1:]
    return masks[:, :1], iou_pred[:, :1]


def postprocess_masks(masks: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear upsample of low-res logits [B, M, h, w] -> [B, M, out, out],
    half-pixel centers (align_corners=False), computed in float32; for an
    upsample this equals jax.image.resize(method="bilinear")."""
    y = F.interpolate(masks.float(), size=(out_size, out_size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.to(masks.dtype)
