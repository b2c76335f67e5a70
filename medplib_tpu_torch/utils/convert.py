"""Weight bridge: a medplib_tpu param tree, as numpy arrays, -> the port's
tree of torch tensors with the same key paths, dtypes and layouts.

numpy has no bfloat16 of its own: bf16 leaves (ml_dtypes' bfloat16, as
np.asarray gives them from a JAX array) are widened to float32 on the
numpy side and narrowed back to torch.bfloat16 on the torch side, which is
exact. Int8 kernels and their f32 scales carry over byte for byte.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32))).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tree_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts / lists of numpy arrays -> the same nesting of torch
    tensors on `device`. Non-array leaves (None, ints) pass through."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    if tree is None or isinstance(tree, (int, float, bool, str)):
        return tree
    return _leaf(tree, device)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse: torch tensors -> numpy (bf16 widened to float32)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree
