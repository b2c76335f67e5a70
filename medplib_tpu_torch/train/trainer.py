"""Training loop (medplib_tpu/train/trainer.py): the train step over the
trainable leaves only, gradient accumulation, checkpoints, auto-resume with
mid-epoch skip-replay, metric logging, and the in-train validation pass
(`Trainer.validate`, gIoU / cIoU / mIoU / dice through eval/seg_metrics).

The step differentiates only the trainable leaves (the optimizer's mask):
a QLoRA tree's frozen int8 base holds integer tensors autograd cannot
differentiate, and frozen leaves never get a gradient buffer. They pass
through every update untouched (the same tensors).
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
from medplib_tpu_torch.train import lora as lora_lib
from medplib_tpu_torch.train.optimizer import (OptState, Optimizer,
                                               global_norm, make_optimizer)
from medplib_tpu_torch.utils import tree as tree_util
from medplib_tpu_torch.utils.checkpoint import CheckpointManager
from medplib_tpu_torch.utils.logging import (AverageMeter, ProgressMeter,
                                             ScalarWriter)


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int


def create_state(params, tcfg: TrainConfig):
    mask = (lora_lib.trainable_mask(params, tcfg.sft_modules)
            if tcfg.lora_enable else None)
    tx = make_optimizer(tcfg, mask)
    return TrainState(params=params, opt_state=tx.init(params), step=0), tx


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


def make_train_step(cfg: MedplibConfig, tcfg: TrainConfig, tx: Optimizer,
                    seg_flag: bool = True, rp_flag: bool = False):
    """One update over `grad_accumulation_steps` microbatches.

    batches: a Batch whose tensors carry a leading [GA] microbatch axis.
    -> step(state, batches) -> (new state, metrics: dict of 0-dim tensors).
    LoRA dropout seeds fold tcfg.seed, the global step and the microbatch
    index, so every update draws fresh masks and the whole schedule is
    reproducible. The microbatch gradients and metrics are summed as
    `accumulation_path` says, then divided by ga. rp_flag splices the
    region features (stage 2, region adapter or geo sampler)."""
    ga = tcfg.grad_accumulation_steps
    drop_rate = tcfg.lora_dropout if tcfg.lora_enable else 0.0
    base_seed = tcfg.seed ^ 0x10A4

    def loss_fn(params, batch, seed):
        with lora_lib.lora_dropout_ctx(seed, drop_rate):
            out = medplib.model_forward(params, cfg, batch, train=True,
                                        seg_flag=seg_flag, rp_flag=rp_flag,
                                        remat=True)
        metrics = {k: v.detach() for k, v in out.items() if v.dim() == 0}
        return out["loss"], metrics

    def train_step(state: TrainState, batches: medplib.Batch):
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
            g = torch.autograd.grad(loss, train_lv, allow_unused=True)
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

        params_lv = [p.detach() for p in train_lv]
        updates, opt_state = tx.update(grads, state.opt_state, params_lv)
        new = iter([(p + u).to(p.dtype) for p, u in zip(params_lv, updates)])
        params = tree_util.unflatten(
            state.params,
            [next(new) if m else p for p, m in zip(leaves, m_lv)])
        metrics["grad_norm"] = global_norm(grads)
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    return train_step


class Trainer:
    """Epoch loop with checkpoints, resume and scalar logging."""

    def __init__(self, cfg: MedplibConfig, tcfg: TrainConfig, params,
                 log_dir: str, seg_flag: bool = True, rp_flag: bool = False):
        if not cfg.seg.train_mask_decoder:
            # SegConfig.train_mask_decoder gates the mask decoder's
            # trainability
            tcfg = dataclasses.replace(tcfg, sft_modules=tuple(
                m for m in tcfg.sft_modules if m != "mask_decoder"))
        self.cfg, self.tcfg = cfg, tcfg
        self.state, self.tx = create_state(params, tcfg)
        self.step_fn = make_train_step(cfg, tcfg, self.tx, seg_flag, rp_flag)
        self.writer = ScalarWriter(log_dir)
        self.ckpt = CheckpointManager(os.path.join(log_dir, "ckpt_model"))
        self.log_dir = log_dir
        self._rp_flag = rp_flag

    def _tree(self, state: TrainState) -> Dict[str, Any]:
        o = state.opt_state
        return {"params": state.params,
                "opt_state": {"count": torch.tensor(o.count),
                              "mu": list(o.mu), "nu": list(o.nu)},
                "step": torch.tensor(state.step)}

    def resume_if_possible(self) -> int:
        """Restore the newest checkpoint -> its global step (0 if none)."""
        restored, step = self.ckpt.restore(self._tree(self.state))
        if step is None:
            return 0
        o = restored["opt_state"]
        self.state = TrainState(
            params=restored["params"],
            opt_state=OptState(count=int(o["count"]), mu=o["mu"],
                               nu=o["nu"]),
            step=int(restored["step"]))
        return int(step)

    def save(self, step: int):
        self.ckpt.save(step, self._tree(self.state))

    def validate(self, val_batches: Iterator) -> Dict[str, float]:
        """The in-train validation pass: a teacher-forced model_forward
        (train=False, no remat) per batch; each valid <SEG> slot
        (seg_valid & mask_valid) binarized at sigmoid > 0.1 in the padded
        SAM frame against gt_masks. -> giou (mean per-sample IoU, SegMeter),
        ciou (IoU of the summed intersections and unions), miou, dice (the
        mean of 2·IoU / (1 + IoU)) and the mean loss. The pass runs in one
        process: summing the meters over processes waits for the port's
        multi-process training."""
        from medplib_tpu_torch.eval.seg_metrics import (SegMeter,
                                                        binarize_logits)
        meter = SegMeter()
        iou_list, loss_list = [], []
        with torch.no_grad():
            for batch in val_batches:
                out = medplib.model_forward(
                    self.state.params, self.cfg, batch, train=False,
                    seg_flag=True, rp_flag=self._rp_flag, remat=False)
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
        res = meter.results()
        n = max(len(iou_list), 1)
        res.update(miou=float(sum(iou_list) / n),
                   dice=float(sum(2 * i / (1 + i) for i in iou_list) / n),
                   loss=float(sum(loss_list) / max(len(loss_list), 1)))
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
