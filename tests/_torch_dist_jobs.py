"""Rank-side jobs of tests/test_torch_distributed.py. The spawned rank
processes import this module (and the port), never JAX: every job takes
host (numpy) trees and batches and returns host values.

Each job is fn(device, ...) for parallel/dryrun.RankPool.run: it builds
its mesh, takes its shards of the params and its rows of the batch, runs
under set_mesh and all-gathers what the test compares."""

import contextlib
import os

import numpy as np
import torch

from medplib_tpu_torch.config import MeshConfig
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.parallel import mesh as pm
from medplib_tpu_torch.utils import tree as tree_util
from medplib_tpu_torch.utils.convert import tree_from_numpy
from medplib_tpu_torch.utils.quantize import dynamic_act_quant


def batch_to_numpy(batch):
    return {k: np.asarray(getattr(batch, k)) for k in batch._fields
            if getattr(batch, k) is not None}


def batch_from_numpy(arrays, dev="cpu"):
    return tm.Batch(**{k: torch.as_tensor(v).to(dev)
                       for k, v in arrays.items()})


def _setup(dev, shape, host):
    mesh = pm.make_mesh(MeshConfig(*shape))
    full = tree_from_numpy(host, dev)
    return mesh, pm.shard_params(mesh, full)


def _rows(mesh, x):
    return mesh.all_gather(x, pm.ROWS).float().cpu().numpy()


@contextlib.contextmanager
def count_kernel_paths():
    """Counts of the K1 / K2 plain versions (the CPU's kernel paths)."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    calls = {"k1": 0, "k2": 0}
    k1, k2 = G.gmm_int4h_plain, D.moe_ffn_decode_int4h_plain

    def c1(*a, **k):
        calls["k1"] += 1
        return k1(*a, **k)

    def c2(*a, **k):
        calls["k2"] += 1
        return k2(*a, **k)

    G.gmm_int4h_plain, D.moe_ffn_decode_int4h_plain = c1, c2
    try:
        yield calls
    finally:
        G.gmm_int4h_plain, D.moe_ffn_decode_int4h_plain = k1, k2


@contextlib.contextmanager
def count_drops():
    """-> list of the dropped-entry masks of every sort dispatch."""
    from medplib_tpu_torch.ops import moe
    real, seen = moe.sort_dispatch, []

    def counting(logits, k, capacity):
        d = real(logits, k, capacity)
        seen.append((d.token_slot >= logits.shape[1] * capacity
                     ).cpu().numpy())
        return d

    moe.sort_dispatch = counting
    try:
        yield seen
    finally:
        moe.sort_dispatch = real


def generate_job(dev, shape, host, cfg, batch_np, new, actq, ep_shard,
                 stream=False, max_segs=1):
    """generate (and with `stream` the streaming entry points) on the
    mesh -> the whole batch's outputs and this rank's K1 / K2 calls."""
    mesh, params = _setup(dev, shape, host)
    batch = pm.host_local_batch_to_global(mesh, batch_from_numpy(batch_np,
                                                                 dev))
    out = {}
    with pm.set_mesh(mesh), dynamic_act_quant(actq), \
            count_kernel_paths() as calls:
        r = tm.generate(params, cfg, batch, max_new_tokens=new,
                        ep_shard=ep_shard, max_segs=max_segs)
        out.update(k1=calls["k1"], k2=calls["k2"])
        for k in ("output_ids", "num_generated", "seg_valid", "has_seg",
                  "pred_masks"):
            out[k] = _rows(mesh, getattr(r, k))
        if stream:
            half = new // 2
            st = tm.stream_prefill(params, cfg, batch, new,
                                   max_segs=max_segs, ep_shard=ep_shard)
            st, t1, _ = tm.stream_decode_chunk(params, cfg, st, half,
                                               ep_shard=ep_shard)
            st, t2, _ = tm.stream_decode_chunk(params, cfg, st, new - half,
                                               ep_shard=ep_shard)
            masks, valid = tm.stream_ground(params, cfg, batch, st)
            out["stream_ids"] = _rows(mesh, torch.cat([t1, t2], 1))
            out["stream_masks"] = _rows(mesh, masks)
            out["stream_valid"] = _rows(mesh, valid)
    return out


def moe_job(dev, shape, moe_np, x_np, mcfg, mode, ep_shard):
    """One moe_mlp layer (train=True) on this rank's rows -> (the whole
    batch's output, aux loss, dropped-entry masks)."""
    mesh = pm.make_mesh(MeshConfig(*shape))
    moe = pm.shard_params(mesh, {"moe": tree_from_numpy(moe_np, dev)})
    x = pm.host_local_batch_to_global(mesh, torch.as_tensor(x_np).to(dev))
    from medplib_tpu_torch.ops.moe import moe_mlp
    with pm.set_mesh(mesh), count_drops() as drops:
        y, aux = moe_mlp(moe["moe"], x, mcfg, train=True, ep_shard=ep_shard,
                         dispatch_mode=mode)
        y = mesh.all_gather(y, pm.ROWS)
    return y.numpy(), float(aux), drops


def _trainable(state, tx):
    lv = tree_util.leaves_with_paths(state.params)
    mask = (tree_util.leaves(tx.mask) if tx.mask is not None
            else [True] * len(lv))
    return {"/".join(p): v for (p, v), m in zip(lv, mask) if m}


def train_step(params, cfg, tcfg, batch, ep_shard=False, mesh=None):
    """One make_train_step update -> (metrics, trainable leaves before,
    after (consolidated, numpy), dropped-entry masks)."""
    from medplib_tpu_torch.train.trainer import (consolidate, create_state,
                                                 make_train_step)
    state, tx = create_state(params, tcfg)
    step = make_train_step(cfg, tcfg, tx, ep_shard=ep_shard)
    mb = tm.Batch(*[None if x is None else x[None] for x in batch])
    with count_drops() as drops:
        new, metrics = step(state, mb)
    before, after = state, new
    if mesh is not None:
        before = before._replace(params=consolidate(mesh, state.params))
        after = after._replace(params=consolidate(mesh, new.params))
    to_np = lambda d: {k: v.detach().float().cpu().numpy()  # noqa: E731
                       for k, v in d.items()}
    return ({k: float(v) for k, v in metrics.items()},
            to_np(_trainable(before, tx)), to_np(_trainable(after, tx)),
            drops)


def train_job(dev, shape, host, cfg, tcfg, batch_np, ep_shard):
    mesh, params = _setup(dev, shape, host)
    batch = pm.host_local_batch_to_global(mesh, batch_from_numpy(batch_np,
                                                                 dev))
    with pm.set_mesh(mesh):
        return train_step(params, cfg, tcfg, batch, ep_shard, mesh)


def validate_job(dev, shape, host, cfg, tcfg, batches_np, log_dir,
                 ep_shard):
    """Trainer.validate over the batches -> its results dict."""
    from medplib_tpu_torch.train.trainer import Trainer
    mesh, params = _setup(dev, shape, host)
    batches = [pm.host_local_batch_to_global(mesh, batch_from_numpy(b, dev))
               for b in batches_np]
    with pm.set_mesh(mesh):
        tr = Trainer(cfg, tcfg, params,
                     os.path.join(log_dir, f"rank{mesh.rank}"),
                     ep_shard=ep_shard)
        return tr.validate(iter(batches))


def cli_rank(argv, rank, results):
    """One process of the training CLI with the offline tokenizer of
    tests/test_cli.py (spawned with PYTHONHASHSEED fixed, so every process
    tokenizes alike) -> puts (rank, ok, value) on `results`."""
    import traceback

    import transformers

    from test_cli import FakeHFTok
    torch.set_num_threads(1)
    fake = FakeHFTok()
    transformers.AutoTokenizer.from_pretrained = staticmethod(
        lambda *_a, **_k: fake)
    try:
        from medplib_tpu_torch.train import cli
        results.put((rank, True, cli.main(argv)))
    except BaseException:   # noqa: BLE001 - reported to the test
        results.put((rank, False, traceback.format_exc()))
