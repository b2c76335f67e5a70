"""Checkpoint I/O with save / auto-resume semantics
(medplib_tpu/utils/checkpoint.py, orbax there): numbered step directories
under `directory`, pruning to the newest `max_to_keep`, and a restore into
a template's devices and dtypes. A checkpoint is one torch.save file of a
tree of dicts, lists and tensors, loaded back with weights_only=True.
save_params / load_params write and read one such file for a params tree
(an orbax directory of the JAX package needs JAX to read; a released
checkpoint loads through utils/export.load_reference_checkpoint)."""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import torch

_FILE = "state.pt"


def _to_template(loaded: Any, template: Any, path: str = "") -> Any:
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f"checkpoint tree differs from the template at "
                             f"{path or '/'}")
        return {k: _to_template(loaded[k], v, f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(loaded) != len(template):
            raise ValueError(f"checkpoint list length differs at {path}")
        return type(template)(_to_template(a, b, f"{path}/{i}")
                              for i, (a, b) in enumerate(zip(loaded,
                                                             template)))
    if isinstance(template, torch.Tensor):
        if tuple(loaded.shape) != tuple(template.shape):
            raise ValueError(f"shape {tuple(loaded.shape)} in the checkpoint "
                             f"vs {tuple(template.shape)} at {path}")
        return loaded.to(device=template.device, dtype=template.dtype)
    return loaded


def _own_storage(tree: Any) -> Any:
    """torch.save writes a view's whole storage: a leaf that is a view of
    a larger tensor (one layer of a stack) is copied out first."""
    if isinstance(tree, dict):
        return {k: _own_storage(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_own_storage(v) for v in tree)
    if isinstance(tree, torch.Tensor) and \
            tree.untyped_storage().nbytes() > tree.numel() * tree.element_size():
        return tree.clone()
    return tree


def save_params(path: str, params: Any) -> None:
    """Write a params tree to one file (whole or not at all). Leaves that
    view a larger storage are written as their own elements only."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix="tmp",
                               suffix=".pt")
    os.close(fd)
    try:
        torch.save(_own_storage(params), tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_params(path: str, template: Optional[Any] = None,
                device="cuda") -> Any:
    """A tree written by save_params, on `device`; with a template, on the
    template's devices and dtypes, its tree structure and shapes
    checked."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu",
                        weights_only=True)
    if template is not None:
        return _to_template(loaded, template)
    return _to_device(loaded, device)


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.exists(os.path.join(self.directory, d,
                                                      _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write `state` for `step` (whole or not at all), then drop all but
        the newest max_to_keep steps."""
        final = os.path.join(self.directory, str(step))
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp")
        try:
            torch.save(state, os.path.join(tmp, _FILE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state_template: Any,
                step: Optional[int] = None) -> Tuple[Any, Optional[int]]:
        """-> (state on the template's devices and dtypes, step), or
        (template, None) when there is nothing to resume."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state_template, None
        loaded = torch.load(os.path.join(self.directory, str(step), _FILE),
                            map_location="cpu", weights_only=True)
        return _to_template(loaded, state_template), step
