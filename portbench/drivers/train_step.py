"""Driver: stage-3 QLoRA training steps through `train/trainer.
make_train_step`, the training entry of the port.

Set-up builds the configuration's tree from the seed (bf16 draws on the
card; the language model int8 through the port's quantizer; LoRA on the
target modules with the seed's adapters), the optimizer state and ONE step
object, and drives that object through the cell's first `check_steps`
steps on batches 0, 1, ...: their losses, the first gradient as the
optimizer holds it after step 1 (its first moment / (1 - beta1)), the
embedding rows that gradient touches, and the trainable leaves' change
over those steps are kept for the comparison.
The same object then steps through the window on fresh batches, each
step's loss read back before the next (a closed loop); the window closes
when the step in flight at the deadline returns. A traced run profiles
`profile_calls` more steps.

After the window the tree is freed and the plain reference follows the
first steps from the same weights and batches
(portbench/reference/train.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

from portbench import counts, traffic, tracing, weights
from portbench.drivers.generate_batch import _cast, _materialize


def port_config(model: dict):
    """The configuration file -> the port's dense MedplibConfig."""
    from medplib_tpu_torch.config import MoeConfig
    from portbench.drivers import generate_batch
    dense = dict(model, medplib=dict(model["medplib"],
                                     moe={"num_experts": 2}))
    cfg = generate_batch.port_config(dense)
    return dataclasses.replace(cfg, moe=MoeConfig())


def train_config(model: dict):
    from medplib_tpu_torch.config import SegConfig, TrainConfig
    t = model["training"]
    keys = ("lr", "beta1", "beta2", "weight_decay", "grad_clip_norm",
            "warmup_steps", "total_steps", "seed", "lora_r", "lora_alpha",
            "lora_dropout")
    tcfg = TrainConfig(**{k: t[k] for k in keys},
                       lora_target_modules=tuple(t["lora_target_modules"]),
                       sft_modules=tuple(t["sft_modules"]))
    seg = SegConfig(out_dim=model["medplib"]["seg"]["out_dim"],
                    ce_loss_weight=t["ce_loss_weight"],
                    bce_loss_weight=t["bce_loss_weight"],
                    dice_loss_weight=t["dice_loss_weight"])
    return tcfg, seg


def build_params(cfg, model: dict, seed: int, device):
    """The QLoRA tree: every leaf drawn from the seed, the language model
    quantized by the port, adapters on the target modules (drawn from the
    seed as well)."""
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.train import lora
    from medplib_tpu_torch.utils import quantize as qz
    t = model["training"]
    skel = medplib.init_medplib(torch.Generator(), cfg, torch.bfloat16,
                                "meta")
    params = _materialize(skel, "", seed, device)
    del skel
    params["llm"] = qz.quantize_tree(params["llm"], bits=t["llm_bits"])
    params["llm"] = lora.inject(torch.Generator(device=device),
                                params["llm"], tuple(t["lora_target_modules"]),
                                r=t["lora_r"])
    attn = params["llm"]["layers"]["attn"]
    for name in t["lora_target_modules"]:
        for leaf in ("lora_a", "lora_b"):
            path = f"llm/layers/attn/{name}/{leaf}"
            stack = attn[name][leaf]
            for i in range(stack.shape[0]):
                stack[i] = weights.draw(seed, path, stack.shape[1:], device,
                                        layer=i)
    dtype = getattr(torch, t["dtype"])
    return params if dtype == torch.bfloat16 else _cast(params, dtype)


def trainable(params, mask) -> List[tuple]:
    """[(path, leaf)] of the trainable leaves, in the tree's leaf order."""
    from medplib_tpu_torch.utils import tree as tree_util
    return [("/".join(p), leaf) for (p, leaf), m in zip(
        tree_util.leaves_with_paths(params), tree_util.leaves(mask)) if m]


class Driver:
    def __init__(self, model: dict, mix: dict, cell: dict, seed: int,
                 device):
        self.model, self.mix, self.cell = model, mix, cell
        self.seed, self.device = seed, torch.device(device)

    # -- set-up: the object and its first steps -----------------------------
    def setup(self) -> None:
        from medplib_tpu_torch.train import trainer
        if self.device.type == "cuda":
            from medplib_tpu_torch.ops.cuda import _build
            _build.load_library()
        self.cfg = port_config(self.model)
        self.tcfg, seg = train_config(self.model)
        self.cfg = dataclasses.replace(self.cfg, seg=seg)
        params = build_params(self.cfg, self.model, self.seed, self.device)
        self.state, tx = trainer.create_state(params, self.tcfg)
        self.step = trainer.make_train_step(self.cfg, self.tcfg, tx)
        leaves = trainable(self.state.params, tx.mask)
        self.paths = [p for p, _ in leaves]
        before = [x.detach().clone() for _, x in leaves]
        self.losses, self.grad_norms = [], None
        for i in range(self.cell["check_steps"]):
            self.state, m = self.step(self.state, self._batch(i)[1])
            self.losses.append(float(m["loss"]))
            if i == 0:
                from portbench.reference.train import rows_touched
                b1 = self.tcfg.beta1
                mus = self.state.opt_state.mu
                self.grad_norms = [float((mu.float() / (1 - b1)).norm())
                                   for mu in mus]
                self.embed_rows = {p: rows_touched(mu) for p, mu in
                                   zip(self.paths, mus)
                                   if p.endswith("/embedding")}
        after = [x for _, x in trainable(self.state.params, tx.mask)]
        self.change_norms = [float((a.float() - b.float()).norm())
                             for a, b in zip(after, before)]
        del before, after
        self.next_call = self.cell["check_steps"]
        tracing.sync(self.device)

    def _batch(self, call: int):
        from medplib_tpu_torch.models.medplib import Batch
        b = traffic.make(self.mix, self.model, self.seed, call, self.device)
        n = b["ids"].shape[0]
        n_img = self.cfg.vision.num_patches
        one = Batch.make(
            input_ids=b["ids"], input_mask=b["mask"], labels=b["labels"],
            images_clip=b["clip"], images_sam=b["sam"],
            image_token_lengths=torch.full((n, 1), n_img, dtype=torch.int32,
                                           device=self.device),
            gt_masks=b["gt"],
            mask_valid=torch.ones((n, 1), dtype=torch.bool,
                                  device=self.device),
            sam_frame=self.cfg.sam.image_size)
        return b, type(one)(*[None if x is None else x[None] for x in one])

    def _train(self, call: int) -> Dict:
        b, batch = self._batch(call)
        self.state, m = self.step(self.state, batch)
        loss = float(m["loss"])                       # back on the host
        n_img = self.cfg.vision.num_patches
        lens = [int(n) - 1 + n_img for n in b["lens"]]
        return {"loss": loss, "lens": lens,
                "padded": int(b["ids"].shape[1]) - 1 + n_img}

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, trace: bool) -> Dict:
        from medplib_tpu_torch.ops.cuda import flash_attention as FA
        done: List[Dict] = []
        walls: List[float] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            c0 = time.perf_counter()
            done.append(self._train(self.next_call))
            walls.append(time.perf_counter() - c0)
            self.next_call += 1
        t1 = time.perf_counter()
        tokens = sum(sum(d["lens"]) for d in done)
        ctx = {"model": self.model, "window_s": t1 - t0,
               "answers": len(done) * self.mix["batch"],
               "train_tokens_per_s": tokens / (t1 - t0),
               "timed_flops": sum(counts.train_step_flops(
                   self.model, d["lens"]) for d in done),
               "timed_wall_s": sum(walls)}
        if not trace:
            return ctx
        launches = (FA.flash_forward.launches, FA.flash_dq.launches,
                    FA.flash_dkv.launches)
        n_prof = self.cell["profile_calls"]
        tracing.sync(self.device)
        with tracing.profile(self.device) as prof:
            p0 = time.perf_counter()
            prof_out = [self._train(self.next_call + j)
                        for j in range(n_prof)]
            tracing.sync(self.device)
            p_wall = time.perf_counter() - p0
        summary = tracing.summarize(prof)
        ctx.update({
            "profile": summary, "profile_wall_s": p_wall,
            "kernel_s": counts.by_kernel_id(summary["ops"]),
            "flash_bound_s": sum(counts.flash_step_bound_s(
                self.model, d["lens"], d["padded"]) for d in prof_out),
            "launches": {"K4": FA.flash_forward.launches - launches[0],
                         "K5": FA.flash_dq.launches - launches[1],
                         "K6": FA.flash_dkv.launches - launches[2]}})
        return ctx

    # -- the comparison -------------------------------------------------
    def release(self) -> None:
        del self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self) -> Dict:
        return {"losses": self.losses,
                "grad_norms": dict(zip(self.paths, self.grad_norms)),
                "change_norms": dict(zip(self.paths, self.change_norms)),
                "embed_rows": self.embed_rows}

    def _reference(self, bits: int, rows=None, act8=False) -> Dict:
        from portbench.reference import train
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return train.run(self.model, self.mix, self.seed,
                         self.cell["check_steps"], self.device, bits, rows,
                         act8)

    def check(self) -> Dict[str, float]:
        from portbench.reference import train
        want = self._reference(self.model["training"]["llm_bits"])
        return train.readings(self.program_readings(), want)

    def readings_with_control(self):
        """The program's readings over its first steps, and, in its place,
        the control's (float8 inputs to the decoder's linears and lm_head,
        below the configuration's bf16), a planted fault's (half of each
        batch left out, the mean over the rest) and the frozen language
        model in int4 (below its int8)."""
        from portbench.reference import train
        self.release()
        bits = self.model["training"]["llm_bits"]
        want = self._reference(bits)
        prog = train.readings(self.program_readings(), want)
        ctrl = train.readings(self._reference(bits, act8=True), want)
        half = self._reference(bits, rows=self.mix["batch"] // 2)
        ctrl["half_batch"] = train.readings(half, want)
        ctrl["int4_base"] = train.readings(self._reference(4), want)
        return prog, ctrl
