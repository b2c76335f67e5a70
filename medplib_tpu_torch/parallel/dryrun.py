"""Multi-process runs of the distributed port, and its dry run
(__graft_entry__.dryrun_multichip and scripts/dryrun_multihost.py of the
JAX package).

`RankPool` starts `world` processes (spawned, so each imports only this
package), joins them in one torch.distributed group (gloo by default) and
runs jobs on all of them: `pool.run(fn, *args)` calls `fn(device, *args)`
on every rank, a module-level function that builds its mesh with
parallel/mesh.make_mesh, and returns the ranks' results in rank order.
CUDA tensors among the arguments reach the ranks through
torch.multiprocessing's CUDA IPC: the caller keeps them alive until run
returns, and a rank drops them when its job ends, so that the caller's
memory is freed once the caller drops them. Results should be host
values. A rank that raises fails the run, and a run that outlasts its
timeout kills the processes.

    python -m medplib_tpu_torch.parallel.dryrun [N]

runs `dryrun_multichip(N)` (default 4) on the CPU: N gloo processes, the
tiny MoE config (2 experts, top-1, capacity factor 4) on a
(N / 4, 2, 2) mesh: one ep_shard train step (AdamW) whose loss must be
finite and equal on every rank, then a sharded generate (expert-parallel,
tensor-parallel, data-parallel rows) whose tokens must equal one process's
generate on the same (trained, consolidated) params and batch.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import queue
import socket
import sys
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str, backend: str,
               threads: int, jobs, results) -> None:
    import torch.distributed as dist
    from medplib_tpu_torch.parallel.mesh import init_distributed
    torch.set_num_threads(threads)
    try:
        dev = init_distributed(f"localhost:{port}", world, rank,
                               backend=backend, device=device)
        while True:
            job = jobs.get()
            if job is None:
                break
            try:
                out = (rank, True, job[0](dev, *job[1]))
            except BaseException:   # noqa: BLE001 - reported to the caller
                out = (rank, False, traceback.format_exc())
            # drop the job's arguments before waiting for the next one: a
            # CUDA tensor received through IPC keeps its storage allocated
            # in the sending process until every receiver lets it go
            del job
            gc.collect()
            results.put(out)
            del out
    except BaseException:           # noqa: BLE001 - reported to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """`world` rank processes in one process group (module docstring)."""

    def __init__(self, world: int, device: str = "cpu",
                 backend: str = "gloo", timeout: float = 120.0,
                 threads: int = 1):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        port = free_port()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, port, device, backend,
                                        threads, self.jobs[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn: Callable, *args, timeout: Optional[float] = None
            ) -> List[Any]:
        """fn(device, *args) on every rank -> the results in rank order."""
        for q in self.jobs:
            q.put((fn, args))
        out: List[Any] = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, val = self.results.get(
                    timeout=timeout or self.timeout)
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(f"{getattr(fn, '__name__', fn)}: the "
                                   f"ranks did not finish within "
                                   f"{timeout or self.timeout} s")
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        return out

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q in self.jobs:
                q.put(None)
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(kill=exc[0] is not None)


def run_ranks(world: int, fn: Callable, *args, **pool_kw) -> List[Any]:
    """One job on a fresh pool of `world` ranks."""
    with RankPool(world, **pool_kw) as pool:
        return pool.run(fn, *args)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def tiny_moe_cfg():
    """The dry run's model: MedplibConfig.tiny with 2 experts, top-1,
    capacity factor 4 (the JAX dry run's)."""
    from medplib_tpu_torch.config import MedplibConfig, MoeConfig
    return dataclasses.replace(
        MedplibConfig.tiny(),
        moe=MoeConfig(enable=True, num_experts=2, top_k=1,
                      capacity_factor=4.0, eval_capacity_factor=4.0,
                      moe_mode="dense"))


def make_batch(cfg, b: int, t: int, rng: np.random.Generator,
               device="cpu"):
    """__graft_entry__._make_batch: random ids with BOS, an <image>
    sentinel at 2 and <SEG> at T-3, half the labels ignored; CLIP pixels
    N(0, 1), SAM pixels 0..255, one random valid mask per row."""
    from medplib_tpu_torch.config import IMAGE_TOKEN_INDEX
    from medplib_tpu_torch.models.medplib import Batch
    ids = rng.integers(3, min(cfg.llm.vocab_size, cfg.seg_token_idx),
                       size=(b, t))
    ids[:, 0] = 1
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids[:, t - 3] = cfg.seg_token_idx
    vs, ss = cfg.vision.image_size, cfg.sam.image_size
    labels = ids.copy()
    labels[:, : t // 2] = -100
    clip_px = rng.normal(size=(b, 1, vs, vs, 3)).astype(np.float32)
    sam_px = rng.uniform(0, 255, size=(b, ss, ss, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, 1, ss, ss)) > 0.5).astype(np.float32)
    td = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return Batch.make(
        input_ids=td(ids), input_mask=td(np.ones((b, t), np.int32)),
        labels=td(labels), images_clip=td(clip_px), images_sam=td(sam_px),
        image_token_lengths=td(np.full((b, 1), cfg.vision.num_patches,
                                       np.int32)),
        gt_masks=td(gt), mask_valid=td(np.ones((b, 1), bool)),
        sam_frame=ss)


def _dryrun_rank(dev, mesh_shape, b: int, t: int, new: int):
    """One rank of dryrun_multichip -> (loss, mesh tokens, one-process
    tokens or None, finite masks)."""
    from medplib_tpu_torch.config import MeshConfig, TrainConfig
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.parallel.mesh import (
        ROWS, host_local_batch_to_global, make_mesh, set_mesh, shard_params)
    from medplib_tpu_torch.train.trainer import (consolidate, create_state,
                                                 make_train_step)

    cfg = tiny_moe_cfg()
    mesh = make_mesh(MeshConfig(*mesh_shape))
    full = medplib.init_medplib(torch.Generator().manual_seed(0), cfg,
                                torch.float32, dev)
    batch = make_batch(cfg, b, t, np.random.default_rng(0), dev)
    tcfg = TrainConfig(lr=1e-4, warmup_steps=0, total_steps=10,
                       lora_enable=False)
    with set_mesh(mesh):
        state, tx = create_state(shard_params(mesh, full), tcfg)
        step = make_train_step(cfg, tcfg, tx, ep_shard=True)
        local = host_local_batch_to_global(mesh, batch)
        mb = medplib.Batch(*[None if x is None else x[None] for x in local])
        state, metrics = step(state, mb)
        res = medplib.generate(state.params, cfg, local, max_new_tokens=new,
                               max_segs=2, ep_shard=True)
        toks = mesh.all_gather(res.output_ids, ROWS)
        trained = consolidate(mesh, state.params)
    single = None
    if mesh.rank == 0:
        ref = medplib.generate(trained, cfg, batch, max_new_tokens=new,
                               max_segs=2)
        single = ref.output_ids.cpu().numpy()
    return (float(metrics["loss"]), toks.cpu().numpy(), single,
            bool(torch.isfinite(res.pred_masks).all()))


def dryrun_multichip(n_devices: int = 4, timeout: float = 300.0) -> None:
    """n_devices gloo CPU processes on a (n / 4, 2, 2) mesh (module
    docstring). Prints `dryrun_multichip OK ...`; raises on a mismatch."""
    if n_devices % 4:
        raise ValueError("the dry run's mesh is (n / 4, 2, 2)")
    shape = (n_devices // 4, 2, 2)
    b = shape[0] * shape[1] * 2
    out = run_ranks(n_devices, _dryrun_rank, shape, b, 16, 6,
                    timeout=timeout)
    losses = [o[0] for o in out]
    if not all(np.isfinite(losses)) or len(set(losses)) != 1:
        raise AssertionError(f"rank losses differ or are not finite: "
                             f"{losses}")
    toks, single = out[0][1], out[0][2]
    if not all(np.array_equal(o[1], toks) for o in out):
        raise AssertionError("ranks gathered different tokens")
    if not np.array_equal(toks, single):
        raise AssertionError(f"sharded generate tokens diverge:\n{toks}\n"
                             f"vs one process\n{single}")
    if not all(o[3] for o in out):
        raise AssertionError("non-finite masks")
    print(f"dryrun_multichip OK: mesh={dict(data=shape[0], expert=2, model=2)}"
          f" loss={losses[0]:.4f} gen_tokens_equal={toks.shape}",
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dryrun_multichip(int(argv[0]) if argv else 4)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
