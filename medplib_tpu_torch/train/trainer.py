"""Training loop (medplib_tpu/train/trainer.py): the train step over the
trainable leaves only, gradient accumulation, checkpoints, auto-resume with
mid-epoch skip-replay, metric logging, and the in-train validation pass
(`Trainer.validate`, gIoU / cIoU / mIoU / dice through eval/seg_metrics).

The step differentiates only the trainable leaves (the optimizer's mask):
a QLoRA tree's frozen int8 base holds integer tensors autograd cannot
differentiate, and frozen leaves never get a gradient buffer. They pass
through every update untouched (the same tensors).

Distributed (parallel/mesh.py): called inside set_mesh, the step takes
this rank's rows and params shards. Every rank computes the global loss,
differentiates loss / world size, and `reduce_grads` sums each leaf's
gradient over the ranks that hold the same copy of it (the axes
shard_spec does not split it over: a replicated leaf over every rank,
expert leaves under EP over data and model, a TP-split leaf over data and
expert); the clip's global norm counts every shard once. Validation sums
the meters over the row shards, and a checkpoint holds the consolidated
tree one process would save, written by rank 0.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch

from medplib_tpu_torch.config import MedplibConfig, TrainConfig
from medplib_tpu_torch.models import medplib
from medplib_tpu_torch.parallel.mesh import (AXIS_NAMES, ROWS, current_mesh,
                                             shard_spec, sharded_axes)
from medplib_tpu_torch.train import lora as lora_lib
from medplib_tpu_torch.train.optimizer import (OptState, Optimizer,
                                               global_norm, make_optimizer)
from medplib_tpu_torch.utils import tree as tree_util
from medplib_tpu_torch.utils.checkpoint import CheckpointManager
from medplib_tpu_torch.utils.logging import (AverageMeter, ProgressMeter,
                                             ScalarWriter)


class _NoWriter:
    def add_scalar(self, *_a, **_k):
        pass

    add_scalars = add_scalar


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int


def create_state(params, tcfg: TrainConfig):
    mask = (lora_lib.trainable_mask(params, tcfg.sft_modules)
            if tcfg.lora_enable else None)
    tx = make_optimizer(tcfg, mask)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


def _full(mesh, path, leaf):
    """A whole leaf from this rank's shard of it."""
    for dim, a in enumerate(shard_spec(path, leaf)):
        if a is not None and mesh.size(a) > 1:
            leaf = mesh.all_gather(leaf, a, dim=dim)
    return leaf


def _microbatch(batches: medplib.Batch, i: int) -> medplib.Batch:
    return medplib.Batch(*[None if x is None else x[i] for x in batches])


def accumulation_path(ga: int) -> str:
    """How a step sums its microbatch gradients, read from the environment
    variables the JAX train step reads, with their defaults: "direct" (one
    microbatch), "unrolled" (ga <= MEDPLIB_TRAIN_UNROLL_MAX, default 8, or
    MEDPLIB_TRAIN_UNROLL_GA set: sums in the leaf dtype) or "scan" (above
    that, or MEDPLIB_TRAIN_FORCE_SCAN set: sums into f32 zeros)."""
    env = os.environ
    if env.get("MEDPLIB_TRAIN_FORCE_SCAN"):
        return "scan"
    if ga == 1:
        return "direct"
    if env.get("MEDPLIB_TRAIN_UNROLL_GA") or ga <= int(
            env.get("MEDPLIB_TRAIN_UNROLL_MAX", "8")):
        return "unrolled"
    return "scan"


def _leaf_axes(tree) -> list:
    """The mesh axes each leaf of `tree` is split over (shard_spec)."""
    return [sharded_axes(shard_spec(path, leaf))
            for path, leaf in tree_util.leaves_with_paths(tree)]


def reduce_grads(mesh, grads: list, split: list) -> list:
    """Sum each gradient over the mesh axes its leaf is NOT split over
    (the ranks holding the same copy), one collective per (axes, dtype)
    bucket."""
    out = list(grads)
    buckets: Dict[tuple, list] = {}
    for i, (g, ax) in enumerate(zip(grads, split)):
        rest = tuple(a for a in AXIS_NAMES
                     if a not in ax and mesh.size(a) > 1)
        if rest:
            buckets.setdefault((rest, g.dtype), []).append(i)
    for (rest, _), idx in buckets.items():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = mesh.all_reduce(flat, rest)
        for i, part in zip(idx, torch.split(flat, [grads[i].numel()
                                                   for i in idx])):
            out[i] = part.reshape(grads[i].shape)
    return out


def consolidate(mesh, tree):
    """The whole tree from this rank's shards (a collective: every rank
    calls it)."""
    lv = [_full(mesh, p, leaf)
          for p, leaf in tree_util.leaves_with_paths(tree)]
    return tree_util.unflatten(tree, lv)


def make_train_step(cfg: MedplibConfig, tcfg: TrainConfig, tx: Optimizer,
                    seg_flag: bool = True, rp_flag: bool = False,
                    ep_shard: bool = False):
    """One update over `grad_accumulation_steps` microbatches.

    batches: a Batch whose tensors carry a leading [GA] microbatch axis.
    -> step(state, batches) -> (new state, metrics: dict of 0-dim tensors).
    LoRA dropout seeds fold tcfg.seed, the global step and the microbatch
    index, so every update draws fresh masks and the whole schedule is
    reproducible. The microbatch gradients and metrics are summed as
    `accumulation_path` says, then divided by ga. rp_flag splices the
    region features (stage 2, region adapter or geo sampler). ep_shard:
    expert-parallel MoE under the ambient mesh (module docstring)."""
    ga = tcfg.grad_accumulation_steps
    drop_rate = tcfg.lora_dropout if tcfg.lora_enable else 0.0
    base_seed = tcfg.seed ^ 0x10A4

    def loss_fn(params, batch, seed):
        with lora_lib.lora_dropout_ctx(seed, drop_rate):
            out = medplib.model_forward(params, cfg, batch, train=True,
                                        seg_flag=seg_flag, rp_flag=rp_flag,
                                        remat=True, ep_shard=ep_shard)
        metrics = {k: v.detach() for k, v in out.items() if v.dim() == 0}
        return out["loss"], metrics

    def train_step(state: TrainState, batches: medplib.Batch):
        mesh = current_mesh()
        world = 1 if mesh is None else mesh.world
        leaves = tree_util.leaves(state.params)
        m_lv = (tree_util.leaves(tx.mask) if tx.mask is not None
                else [True] * len(leaves))
        train_lv = [p.detach().requires_grad_(True)
                    for p, m in zip(leaves, m_lv) if m]
        it = iter(train_lv)
        full = tree_util.unflatten(
            state.params, [next(it) if m else p for p, m in zip(leaves, m_lv)])

        def grads_of(i):
            seed = lora_lib.mix_seed(base_seed, state.step, i)
            loss, metrics = loss_fn(full, _microbatch(batches, i), seed)
            g = torch.autograd.grad(loss / world if world > 1 else loss,
                                    train_lv, allow_unused=True)
            return ([torch.zeros_like(p) if gi is None else gi
                     for gi, p in zip(g, train_lv)], metrics)

        path = accumulation_path(ga)
        grads, metrics = grads_of(0)
        if path == "scan":
            # the reference's scan sums into f32 zeros, so bf16 leaves get
            # f32 gradients (and the optimizer f32 moments)
            grads = [torch.zeros_like(g, dtype=torch.float32) + g
                     for g in grads]
            metrics = {k: torch.zeros_like(v, dtype=torch.float32) + v
                       for k, v in metrics.items()}
        for i in range(1, ga):
            g, m = grads_of(i)
            grads = [a + b for a, b in zip(grads, g)]
            metrics = {k: metrics[k] + m[k] for k in metrics}
        if path != "direct":
            grads = [g / ga for g in grads]
            metrics = {k: v / ga for k, v in metrics.items()}

        split = None
        if mesh is not None:
            split = [ax for ax, m in zip(_leaf_axes(state.params), m_lv)
                     if m]
            grads = reduce_grads(mesh, grads, split)
        g_norm = global_norm(grads, mesh, split)
        params_lv = [p.detach() for p in train_lv]
        updates, opt_state = tx.update(grads, state.opt_state, params_lv,
                                       g_norm)
        new = iter([(p + u).to(p.dtype) for p, u in zip(params_lv, updates)])
        params = tree_util.unflatten(
            state.params,
            [next(new) if m else p for p, m in zip(leaves, m_lv)])
        metrics["grad_norm"] = g_norm
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step


class Trainer:
    """Epoch loop with checkpoints, resume and scalar logging."""

    def __init__(self, cfg: MedplibConfig, tcfg: TrainConfig, params,
                 log_dir: str, seg_flag: bool = True, rp_flag: bool = False,
                 ep_shard: bool = False):
        if not cfg.seg.train_mask_decoder:
            # SegConfig.train_mask_decoder gates the mask decoder's
            # trainability
            tcfg = dataclasses.replace(tcfg, sft_modules=tuple(
                m for m in tcfg.sft_modules if m != "mask_decoder"))
        self.cfg, self.tcfg = cfg, tcfg
        self.state, self.tx = create_state(params, tcfg)
        self.step_fn = make_train_step(cfg, tcfg, self.tx, seg_flag, rp_flag,
                                       ep_shard)
        mesh = current_mesh()
        # one scalar log per run: rank 0 writes it under a mesh
        self.writer = (ScalarWriter(log_dir) if mesh is None or mesh.rank == 0
                       else _NoWriter())
        self.ckpt = CheckpointManager(os.path.join(log_dir, "ckpt_model"))
        self.log_dir = log_dir
        self._rp_flag, self._ep_shard = rp_flag, ep_shard

    def _tree(self, state: TrainState) -> Dict[str, Any]:
        """The checkpointed tree; under a mesh the consolidated one (the
        moments take their leaves' layouts)."""
        o = state.opt_state
        params, mu, nu = state.params, list(o.mu), list(o.nu)
        mesh = current_mesh()
        if mesh is not None:
            paths = [p for p, _ in tree_util.leaves_with_paths(params)]
            sel = [p for p, m in zip(paths, self._mask_leaves()) if m]
            params = consolidate(mesh, params)
            mu, nu = ([_full(mesh, p, t) for p, t in zip(sel, ts)]
                      for ts in (mu, nu))
        return {"params": params,
                "opt_state": {"count": torch.tensor(o.count),
                              "mu": mu, "nu": nu},
                "step": torch.tensor(state.step)}

    def _mask_leaves(self) -> list:
        lv = tree_util.leaves(self.state.params)
        return (tree_util.leaves(self.tx.mask) if self.tx.mask is not None
                else [True] * len(lv))

    def resume_if_possible(self) -> int:
        """Restore the newest checkpoint -> its global step (0 if none).
        Under a mesh every rank reads the consolidated tree and keeps its
        shards."""
        restored, step = self.ckpt.restore(self._tree(self.state))
        if step is None:
            return 0
        o = restored["opt_state"]
        params, mu, nu = restored["params"], o["mu"], o["nu"]
        mesh = current_mesh()
        if mesh is not None:
            from medplib_tpu_torch.parallel.mesh import (shard_leaf,
                                                         shard_params)
            paths = [p for p, _ in tree_util.leaves_with_paths(params)]
            sel = [p for p, m in zip(paths, self._mask_leaves()) if m]
            params = shard_params(mesh, params)
            mu, nu = ([shard_leaf(mesh, shard_spec(p, t), t)
                       for p, t in zip(sel, ts)] for ts in (mu, nu))
        self.state = TrainState(
            params=params,
            opt_state=OptState(count=int(o["count"]), mu=mu, nu=nu),
            step=int(restored["step"]))
        return int(step)

    def save(self, step: int):
        """Write the checkpoint (under a mesh: consolidated, by rank 0,
        the others waiting for it)."""
        tree = self._tree(self.state)
        mesh = current_mesh()
        if mesh is None or mesh.rank == 0:
            self.ckpt.save(step, tree)
        if mesh is not None and mesh.groups:
            import torch.distributed as dist
            dist.barrier()

    def validate(self, val_batches: Iterator) -> Dict[str, float]:
        """The in-train validation pass: a teacher-forced model_forward
        (train=False, no remat) per batch; each valid <SEG> slot
        (seg_valid & mask_valid) binarized at sigmoid > 0.1 in the padded
        SAM frame against gt_masks. -> giou (mean per-sample IoU, SegMeter),
        ciou (IoU of the summed intersections and unions), miou, dice (the
        mean of 2·IoU / (1 + IoU)) and the mean loss. Under a mesh each rank
        runs its rows and the meter state, the IoU, dice and loss sums and
        their counts are summed over the row shards (the JAX package sums
        them over processes), so every rank returns the one-process
        result."""
        from medplib_tpu_torch.eval.seg_metrics import (SegMeter,
                                                        binarize_logits)
        meter = SegMeter()
        iou_list, loss_list = [], []
        with torch.no_grad():
            for batch in val_batches:
                out = medplib.model_forward(
                    self.state.params, self.cfg, batch, train=False,
                    seg_flag=True, rp_flag=self._rp_flag, remat=False,
                    ep_shard=self._ep_shard)
                preds = out["pred_masks"].float().cpu().numpy()
                valid = (out["seg_valid"].cpu().numpy()
                         & batch.mask_valid.bool().cpu().numpy())
                gts = batch.gt_masks.float().cpu().numpy() > 0
                loss_list.append(float(out["loss"]))
                for b, s in zip(*np.nonzero(valid)):
                    pred = binarize_logits(preds[b, s])
                    meter.update(pred, gts[b, s])
                    union = float(np.logical_or(pred > 0, gts[b, s]).sum())
                    inter = float(np.logical_and(pred > 0, gts[b, s]).sum())
                    iou_list.append(inter / union if union else 0.0)
        sums = np.asarray([sum(iou_list), sum(2 * i / (1 + i)
                                              for i in iou_list),
                           len(iou_list), sum(loss_list), len(loss_list)],
                          np.float64)
        mesh = current_mesh()
        if mesh is not None:
            nc = meter.num_classes
            packed = torch.from_numpy(np.concatenate([
                meter.inter_sum, meter.union_sum, meter.iou_sum,
                [meter.count], sums]).astype(np.float64))
            total = mesh.all_reduce(packed, ROWS).numpy()
            meter.inter_sum, meter.union_sum, meter.iou_sum = (
                total[:nc], total[nc:2 * nc], total[2 * nc:3 * nc])
            meter.count = int(total[3 * nc])
            sums = total[3 * nc + 1:]
        iou_sum, dice_sum, n_iou, loss_sum, n_loss = sums
        res = meter.results()
        n = max(n_iou, 1)
        res.update(miou=float(iou_sum / n), dice=float(dice_sum / n),
                   loss=float(loss_sum / max(n_loss, 1)))
        return res

    def fit(self, batch_iterator: Callable[[], Iterator],
            steps_per_epoch: Optional[int] = None,
            val_batches_fn: Optional[Callable[[], Iterator]] = None) -> int:
        """Train tcfg.epochs epochs of `steps_per_epoch` steps, resuming
        from the newest checkpoint and skipping the batches it consumed.
        A loader that fails is re-opened, at most 3 times per epoch. With
        val_batches_fn, each epoch ends with a checkpoint and then a
        validation pass over val_batches_fn(), logged as val/ scalars.
        -> the global step reached."""
        tcfg = self.tcfg
        spe = steps_per_epoch or tcfg.steps_per_epoch
        start_step = self.resume_if_possible()
        meters: dict = {}
        batch_time = AverageMeter("time", ":.2f")
        global_step = start_step

        for epoch in range(start_step // spe, tcfg.epochs):
            it = batch_iterator()
            skip = global_step - epoch * spe         # mid-epoch skip-replay
            for _ in range(skip):
                next(it)
            progress = ProgressMeter(
                spe, list(meters.values()) + [batch_time],
                prefix=f"epoch {epoch}: ")
            faults = 0
            for local_step in range(skip, spe):
                t0 = time.time()
                batches = None
                while batches is None:
                    try:
                        batches = next(it)
                    except StopIteration:
                        break
                    except Exception as e:  # noqa: BLE001 - loader fault
                        faults += 1
                        if faults > 3:
                            raise RuntimeError(
                                "data loader failed 4 times this epoch; "
                                "aborting instead of looping") from e
                        print(f"data loader error, re-iterating: {e}",
                              flush=True)
                        it = batch_iterator()
                if batches is None:
                    break
                self.state, metrics = self.step_fn(self.state, batches)
                metrics = {k: float(v) for k, v in metrics.items()}
                batch_time.update(time.time() - t0)
                for k, v in metrics.items():
                    if k not in meters:
                        meters[k] = AverageMeter(k, ":.4f")
                        progress.meters = (list(meters.values())
                                           + [batch_time])
                    meters[k].update(v)
                global_step += 1
                if global_step % tcfg.log_steps == 0:
                    progress.display(local_step + 1)
                    self.writer.add_scalars(metrics, global_step,
                                            prefix="train/")
                    self.writer.add_scalar("metrics/total_secs_per_batch",
                                           batch_time.avg, global_step)
                if global_step % tcfg.save_steps == 0:
                    self.save(global_step)
            self.save(global_step)
            if val_batches_fn is not None:
                vres = self.validate(val_batches_fn())
                self.writer.add_scalars(vres, global_step, prefix="val/")
                print(f"epoch {epoch} val: giou={vres['giou']:.4f} "
                      f"ciou={vres['ciou']:.4f} dice={vres['dice']:.4f} "
                      f"loss={vres['loss']:.4f}", flush=True)
        return global_step
