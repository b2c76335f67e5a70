"""Seeded weights: every tensor is drawn from (seed, its key path[, layer]).

Either side (the harness building the port's tree, the plain reference
working a layer out again) calls `draw` with the same key and gets the same
bf16 values on the same device, so neither holds the other's tree. Stacked
leaves ([L, ...] under a layer stack) are drawn one layer at a time.

The initial values follow what each kind of leaf holds in a trained model:
norm weights near 1, small biases and embeddings, kernels at
fan_in ** -0.5 (so every layer keeps its activations' scale).
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Tuple

import torch

# subtrees whose leaves carry a leading layer axis
STACKED = ("llm/layers/", "clip/layers/", "sam/image_encoder/blocks/")

# kernels stored in torch's ConvTranspose2d layout [Cin, Cout, kh, kw]
_TORCH_CONVT = ("spatial_convt", "convt1", "convt2")

_SMALL = ("embedding", "class_embedding", "point_embeddings",
          "not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens",
          "pos_embed", "rel_pos_h", "rel_pos_w", "bias")


def key_of(seed: int, path: str, layer: Optional[int] = None) -> int:
    """A 63-bit generator seed from (seed, path, layer); any int seed."""
    text = f"{int(seed)}|{path}|{-1 if layer is None else int(layer)}"
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def is_stacked(path: str) -> bool:
    return path.startswith(STACKED)


def init_of(path: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of one leaf (one layer's slice for a stacked leaf)."""
    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if path.count("/") >= 1 else ""
    if name == "weight":                       # every norm's scale
        return 1.0, 0.05
    if name in _SMALL:
        return 0.0, 0.02
    if name == "gaussian_matrix":
        return 0.0, 1.0
    if name == "lora_a":                       # [in, r], std 1 / r
        return 0.0, 1.0 / shape[-1]
    if name == "lora_b":                       # adapters already trained
        return 0.0, 0.01
    if name == "kernel":
        if len(shape) == 4 and parent in _TORCH_CONVT:
            fan_in = shape[0] * shape[2] * shape[3]
        elif len(shape) == 4:                  # HWIO convolution
            fan_in = shape[0] * shape[1] * shape[2]
        elif path.startswith("llm/layers/attn/") and parent in (
                "q_proj", "k_proj", "v_proj"):
            fan_in = shape[-1]                 # [out, in]
        else:
            fan_in = shape[-2]                 # [.., in, out]
        return 0.0, 1.0 / math.sqrt(fan_in)
    raise KeyError(f"no initial value is defined for leaf {path!r}")


def draw(seed: int, path: str, shape, device, layer: Optional[int] = None,
         dtype=torch.bfloat16) -> torch.Tensor:
    """The leaf `path` (layer `layer` of it when stacked) as `dtype`."""
    shape = tuple(int(s) for s in shape)
    mean, std = init_of(path, shape)
    if std == 0.0:
        return torch.full(shape, mean, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(key_of(seed, path, layer))
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    t.mul_(std).add_(mean)
    return t.to(dtype)
