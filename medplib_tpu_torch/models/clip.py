"""CLIP ViT vision tower (medplib_tpu/models/clip.py): hidden layer
select (select_layer=-2) + CLS drop. Public images are NHWC as in JAX; the
patch convolution runs NCHW inside."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from medplib_tpu_torch.config import ClipVisionConfig
from medplib_tpu_torch.models.llama import layer_params
from medplib_tpu_torch.ops.initializers import dense_init, embed_init, normal
from medplib_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _lin(gen, din, dout, dtype, device, lead=()):
    return {"kernel": dense_init(gen, din, dout, dtype, device, lead),
            "bias": torch.zeros(tuple(lead) + (dout,), dtype=dtype,
                                device=device)}


def _ln(dim, dtype, device, lead=()):
    shape = tuple(lead) + (dim,)
    return {"weight": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def init_clip_vision(gen: torch.Generator, cfg: ClipVisionConfig,
                     dtype=torch.float32, device="cuda") -> Params:
    h, L = cfg.hidden_size, (cfg.num_layers,)
    p = cfg.patch_size
    return {
        "embeddings": {
            "class_embedding": normal(gen, (h,), dtype, device, 0.02),
            "patch_embedding": {"kernel": normal(gen, (p, p, 3, h), dtype,
                                                 device, 0.02)},
            "position_embedding": {"embedding": embed_init(
                gen, cfg.num_patches + 1, h, dtype, device)},
        },
        "pre_layrnorm": _ln(h, dtype, device),
        "layers": {
            "layer_norm1": _ln(h, dtype, device, L),
            "attn": {n: _lin(gen, h, h, dtype, device, L)
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "layer_norm2": _ln(h, dtype, device, L),
            "mlp": {"fc1": _lin(gen, h, cfg.intermediate_size, dtype, device,
                                L),
                    "fc2": _lin(gen, cfg.intermediate_size, h, dtype, device,
                                L)},
        },
        "post_layernorm": _ln(h, dtype, device),
    }


def _attention(p: Params, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, h = x.shape
    d = h // num_heads

    def proj(name):
        return (x @ p[name]["kernel"] + p[name]["bias"]).reshape(
            b, t, num_heads, d)

    q, k, v = proj("q_proj"), proj("k_proj"), proj("v_proj")
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, h)
    return out @ p["out_proj"]["kernel"] + p["out_proj"]["bias"]


def embeddings(p: Params, pixel_values: torch.Tensor,
               cfg: ClipVisionConfig) -> torch.Tensor:
    """pixel_values [B, H, W, 3] (NHWC) -> [B, 1+P, hidden]."""
    b = pixel_values.shape[0]
    w = p["patch_embedding"]["kernel"]                   # HWIO
    x = pixel_values.to(w.dtype).permute(0, 3, 1, 2)
    patches = F.conv2d(x, w.permute(3, 2, 0, 1), stride=cfg.patch_size)
    patches = patches.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden_size)
    cls = p["class_embedding"].to(patches.dtype).expand(b, 1, -1)
    x = torch.cat([cls, patches], dim=1)
    return x + p["position_embedding"]["embedding"][None]


def encoder_layer(p: Params, x: torch.Tensor, cfg: ClipVisionConfig):
    h = layer_norm(x, p["layer_norm1"]["weight"], p["layer_norm1"]["bias"],
                   cfg.layer_norm_eps)
    x = x + _attention(p["attn"], h, cfg.num_heads)
    h = layer_norm(x, p["layer_norm2"]["weight"], p["layer_norm2"]["bias"],
                   cfg.layer_norm_eps)
    h = quick_gelu(h @ p["mlp"]["fc1"]["kernel"] + p["mlp"]["fc1"]["bias"])
    return x + h @ p["mlp"]["fc2"]["kernel"] + p["mlp"]["fc2"]["bias"]


def forward_features(params: Params, pixel_values: torch.Tensor,
                     cfg: ClipVisionConfig) -> torch.Tensor:
    """-> selected hidden layer's patch features [B, P, hidden]. HF
    indexing: select_layer=-2 is the output after num_layers-1 layers, so
    the layers after the selected one are not run."""
    x = embeddings(params["embeddings"], pixel_values, cfg)
    x = layer_norm(x, params["pre_layrnorm"]["weight"],
                   params["pre_layrnorm"]["bias"], cfg.layer_norm_eps)
    sl = cfg.select_layer
    last = cfg.num_layers + sl if sl < 0 else sl - 1
    for i in range(last + 1):
        x = encoder_layer(layer_params(params["layers"], i), x, cfg)
    return x[:, 1:] if cfg.select_feature == "patch" else x
