"""Optimizer: global-norm clipping -> AdamW with the warmup-decay schedule,
optionally masked (medplib_tpu/train/optimizer.py).

Written by hand to optax's semantics, as optax.chain(clip_by_global_norm,
adamw) with optax.masked computes them; torch.optim.AdamW steps its
schedule and rounds its constants differently:

- clip: g_norm = sqrt(sum of per-leaf sums of g*g), and every update
  becomes (g / g_norm) * max_norm unless g_norm < max_norm;
- Adam moments mu, nu live in the parameter's dtype (bf16 for bf16
  leaves); mu_hat = mu / (1 - b1^(count+1)), nu_hat likewise, and
  u = mu_hat / (sqrt(nu_hat) + eps), eps outside the square root;
- weight decay adds weight_decay * p to u before the learning rate;
- the update is lr(count) * -u, lr from the schedule at the count BEFORE
  this update (0 at the first update when warmup_steps >= 1);
- Python constants take the leaf's dtype before they multiply it (JAX's
  weak typing), schedule values are float32;
- masked: frozen leaves get no state at all.

`Optimizer.update` takes and returns lists aligned with the trainable
leaves (`Optimizer.select(tree)`), in the tree's leaf order.

Under a mesh the leaves are this rank's shards: `global_norm` then sums a
split leaf's squares over the axes it is split over, and counts a whole
(replicated) leaf once, so the clip sees the norm of the whole tree; the
moments are elementwise and live with their shards.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from medplib_tpu_torch.config import TrainConfig
from medplib_tpu_torch.utils import tree as tree_util

Schedule = Callable[[int], np.float32]


def _linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule in float32."""
    def f(count: int) -> np.float32:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)
    return f


def warmup_decay_schedule(cfg: TrainConfig) -> Schedule:
    """0 -> lr over warmup_steps, then linear decay to min_lr_ratio * lr at
    total_steps (optax.join_schedules of two linear schedules)."""
    warm = _linear_schedule(0.0, cfg.lr, cfg.warmup_steps)
    decay = _linear_schedule(cfg.lr, cfg.lr * cfg.min_lr_ratio,
                             max(cfg.total_steps - cfg.warmup_steps, 1))
    b = cfg.warmup_steps
    return lambda count: warm(count) if count < b else decay(count - b)


def global_norm(grads: List[torch.Tensor], mesh=None,
                shard_axes: Optional[List[tuple]] = None) -> torch.Tensor:
    """optax.global_norm: per-leaf sums in the leaf's dtype, promoted as
    they are added. With a mesh, shard_axes[i] names the axes leaf i is
    split over: its sum of squares is summed over them."""
    sq = [(g * g).sum() for g in grads]
    if mesh is not None and shard_axes is not None:
        sq = [mesh.all_reduce(s, ax) if ax else s
              for s, ax in zip(sq, shard_axes)]
    return torch.sqrt(sum(sq))


def _c(x, like: torch.Tensor) -> torch.Tensor:
    """A constant in `like`'s dtype (how JAX applies a Python scalar), as a
    0-dim CPU tensor, which a CUDA op takes as a scalar without a copy."""
    return torch.tensor(float(x), dtype=like.dtype)


class OptState(NamedTuple):
    count: int                 # updates applied so far
    mu: List[torch.Tensor]     # first moments of the trainable leaves
    nu: List[torch.Tensor]     # second moments


class Optimizer:
    """clip_by_global_norm(cfg.grad_clip_norm) -> adamw(schedule, beta1,
    beta2, eps=1e-8, weight_decay), masked by `trainable_mask` (a bool tree
    shaped like the params) when given."""

    def __init__(self, cfg: TrainConfig, trainable_mask: Any = None):
        self.cfg = cfg
        self.mask = trainable_mask
        self.schedule = warmup_decay_schedule(cfg)

    def select(self, params: Any) -> List[torch.Tensor]:
        """The trainable leaves of `params`, in leaf order."""
        lv = tree_util.leaves(params)
        if self.mask is None:
            return lv
        return [p for p, m in zip(lv, tree_util.leaves(self.mask)) if m]

    def init(self, params: Any) -> OptState:
        sel = self.select(params)
        return OptState(count=0,
                        mu=[torch.zeros_like(p) for p in sel],
                        nu=[torch.zeros_like(p) for p in sel])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor],
               g_norm: Optional[torch.Tensor] = None):
        """-> (updates, new state); grads, params and updates are lists
        aligned with `select(params)`. g_norm: the clip's global norm when
        the caller has it (a sharded tree's, from global_norm with its
        mesh), else global_norm(grads)."""
        cfg = self.cfg
        b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < cfg.grad_clip_norm
        grads = [torch.where(keep, g, (g / g_norm.to(g.dtype))
                             * _c(cfg.grad_clip_norm, g)) for g in grads]
        count_inc = state.count + 1
        bc1 = np.float32(1) - np.power(np.float32(b1), np.float32(count_inc))
        bc2 = np.float32(1) - np.power(np.float32(b2), np.float32(count_inc))
        step = np.float32(-1) * self.schedule(state.count)
        mus, nus, updates = [], [], []
        for g, mu, nu, p in zip(grads, state.mu, state.nu, params):
            mu = _c(1 - b1, g) * g + _c(b1, mu) * mu
            nu = _c(1 - b2, g) * (g * g) + _c(b2, nu) * nu
            u = (mu / _c(bc1, mu)) / (torch.sqrt(nu / _c(bc2, nu))
                                      + _c(eps, nu))
            u = u + _c(cfg.weight_decay, p) * p
            updates.append(_c(step, u) * u)
            mus.append(mu)
            nus.append(nu)
        return updates, OptState(count=count_inc, mu=mus, nu=nus)


def make_optimizer(cfg: TrainConfig,
                   trainable_mask: Optional[Any] = None) -> Optimizer:
    return Optimizer(cfg, trainable_mask)
