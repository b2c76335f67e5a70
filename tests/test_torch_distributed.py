"""The distributed port (parallel/mesh.py, parallel/tp.py, the EP
dispatches of ops/moe.py, the sharded train step) on gloo CPU processes,
held to one process and to the JAX package.

Rank processes are spawned by parallel/dryrun.RankPool (one pool of 2 and
one of 4 for the module) and run the jobs of tests/_torch_dist_jobs.py;
every run has its own timeout (at most 120 s). JAX runs here, in the
test process, on the same params carried over through numpy
(utils/convert.py).

- EP = 2, mesh (1, 2, 1): generate on the int4h MoE model of
  tests/test_torch_slice.py (B=16 x T_in=64: 1264 spliced tokens, the
  expert-parallel grouped matmul at prefill and at decode, three K1 calls
  a layer and no K2) against JAX's single-device generate: tokens equal,
  masks within atol 2e-3 / rtol 1e-3 (weight-only linears; under W8A8 the
  port's one-process generate is the reference, as JAX's act-quant flips
  differ, tests/test_torch_slice.py); the streaming entry points under EP
  against EP generate.
- TP = 2, mesh (1, 1, 2): the same generate, column / row-parallel
  attention, vocabulary-split embedding and lm_head.
- Train steps on meshes (2, 2, 1) and (1, 2, 2) (ep_shard) against one
  process's step (loss, grad norm, updates) and JAX's loss; skewed
  routers whose top-1 and top-2 capacity drops must equal one process's.
- Trainer.validate over 2 ranks against 1; train/cli.py in 2 processes
  (--coordinator, --mesh-data 2) against one process; dryrun_multichip(4).
"""

import contextlib
import dataclasses
import multiprocessing
import os
import queue
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import _torch_dist_jobs as jobs
import medplib_tpu.config as jc
from medplib_tpu.models import medplib as jm
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.parallel import dryrun
from medplib_tpu_torch.parallel.dryrun import RankPool
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils.quantize import dynamic_act_quant
from test_torch_slice import MAX_NEW, build_model, port_cfg

torch.set_num_threads(1)
TIMEOUT = 120.0
MASK_TOL = dict(atol=2e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, timeout=TIMEOUT) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, timeout=TIMEOUT) as pool:
        yield pool


@pytest.fixture(scope="module")
def int4h_model():
    import __graft_entry__ as ge
    cfg, jp, _ = build_model()
    batch = ge._make_batch(cfg, 16, 64, np.random.default_rng(0))
    host = jax.tree_util.tree_map(np.asarray, jp)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax.jit(lambda p, bb: jm.generate(
            p, cfg, bb, max_new_tokens=MAX_NEW))(jp, batch)
    bnp = {k: np.asarray(getattr(batch, k)) for k in batch._fields
           if getattr(batch, k) is not None}
    return port_cfg(cfg), host, bnp, want


def _one_process_generate(cfg, host, bnp, actq, fused=True):
    """The port's generate in this process; fused=False keeps the three
    grouped K1 calls at decode (K2's eligibility patched off where
    ops/moe.plan_route reads it), the expert-parallel decode's numerics
    (K2 quantizes its intermediate per row and block, K1's three calls
    per row)."""
    off = mock.patch.object(tmoe, "fused_decode_eligible",
                            lambda *a: False)
    with contextlib.nullcontext() if fused else off, \
            dynamic_act_quant(actq):
        return tm.generate(convert.tree_from_numpy(host, "cpu"), cfg,
                           jobs.batch_from_numpy(bnp),
                           max_new_tokens=MAX_NEW)


def _check_against_jax(got, want):
    np.testing.assert_array_equal(got["output_ids"],
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got["seg_valid"],
                                  np.asarray(want.seg_valid))
    np.testing.assert_array_equal(got["has_seg"], np.asarray(want.has_seg))
    np.testing.assert_allclose(got["pred_masks"],
                               np.asarray(want.pred_masks, np.float32),
                               **MASK_TOL)


def _check_against_port(got, r):
    np.testing.assert_array_equal(got["output_ids"], r.output_ids.numpy())
    np.testing.assert_allclose(got["pred_masks"], r.pred_masks.numpy(),
                               **MASK_TOL)


def test_ep_generate_matches_jax(pool2, int4h_model):
    cfg, host, bnp, want = int4h_model
    out = pool2.run(jobs.generate_job, (1, 2, 1), host, cfg, bnp, MAX_NEW,
                    False, True)
    _check_against_jax(out[0], want)
    # three K1 calls a layer at prefill and at every decode step, no K2
    for o in out:
        assert (o["k1"], o["k2"]) == (3 * 2 * (1 + MAX_NEW), 0)
    # under W8A8 / W4A8 prefill: the port's one-process generate with the
    # same decode path
    got = pool2.run(jobs.generate_job, (1, 2, 1), host, cfg, bnp, MAX_NEW,
                    True, True)[1]
    _check_against_port(got, _one_process_generate(cfg, host, bnp, True,
                                                   fused=False))


def test_ep_stream_matches_ep_generate(pool2, int4h_model):
    cfg, host, bnp, _ = int4h_model
    o = pool2.run(jobs.generate_job, (1, 2, 1), host, cfg, bnp, MAX_NEW,
                  True, True, True)[0]
    np.testing.assert_array_equal(o["stream_ids"], o["output_ids"])
    np.testing.assert_array_equal(o["stream_valid"], o["seg_valid"])
    np.testing.assert_allclose(o["stream_masks"], o["pred_masks"],
                               **MASK_TOL)


def test_ep_shard_without_expert_axis_takes_sort(pool2, int4h_model):
    """ep_shard on a mesh with no expert axis: plan_route keeps the
    whole-stack path off (JAX's stack_experts_for_gmm returns None), so
    prefill and decode take the sort dispatch: no K1, no K2; tokens as
    one process."""
    cfg, host, bnp, want = int4h_model
    out = pool2.run(jobs.generate_job, (2, 1, 1), host, cfg, bnp, MAX_NEW,
                    False, True)
    assert all((o["k1"], o["k2"]) == (0, 0) for o in out)
    np.testing.assert_array_equal(out[0]["output_ids"],
                                  np.asarray(want.output_ids))


@pytest.mark.parametrize("actq", [False, True])
def test_tp_generate_matches(pool2, int4h_model, actq):
    cfg, host, bnp, want = int4h_model
    out = pool2.run(jobs.generate_job, (1, 1, 2), host, cfg, bnp, MAX_NEW,
                    actq, False)
    # the experts are not split: each model rank runs K1 at prefill and
    # the fused K2 at decode
    for o in out:
        assert (o["k1"], o["k2"]) == (3 * 2, 2 * MAX_NEW)
    if actq:
        _check_against_port(out[0],
                            _one_process_generate(cfg, host, bnp, True))
    else:
        _check_against_jax(out[0], want)


def test_tp_generate_packed_dense_tree(pool2):
    """TP = 2 on a packed dense int8 tree (pack_inference's qkv_proj /
    gateup_proj, which shard_spec keeps whole: each rank cuts its q / k / v
    and gate / up blocks out of them, K7's plain version here): tokens and
    masks of one process."""
    import medplib_tpu_torch.config as tc
    from medplib_tpu_torch.models import llama as tllama
    from medplib_tpu_torch.utils.convert import tree_to_numpy
    from medplib_tpu_torch.utils.quantize import quantize_tree
    cfg = tc.MedplibConfig.tiny()
    p = tm.init_medplib(torch.Generator().manual_seed(2), cfg,
                        torch.float32, "cpu")
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    p["llm"] = quantize_tree(tllama.pack_inference(p["llm"]), bits=8)
    assert "qkv_proj" in p["llm"]["layers"]["attn"]
    host = tree_to_numpy(p)
    batch = dryrun.make_batch(cfg, 4, 16, np.random.default_rng(4))
    bnp = jobs.batch_to_numpy(batch)
    got = pool2.run(jobs.generate_job, (1, 1, 2), host, cfg, bnp, MAX_NEW,
                    False, False)[0]
    want = tm.generate(convert.tree_from_numpy(host, "cpu"), cfg, batch,
                       max_new_tokens=MAX_NEW)
    _check_against_port(got, want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_setup(k=1, cf=4.0, skew=False, lora=True, b=8):
    """A tiny MoE tree (JAX init, f32, as numpy), the port config, a
    TrainConfig and a batch of b rows."""
    import __graft_entry__ as ge
    jcfg = jc.MedplibConfig.tiny()
    jcfg = dataclasses.replace(jcfg, moe=jc.MoeConfig(
        enable=True, num_experts=2, top_k=k, capacity_factor=cf,
        eval_capacity_factor=cf, moe_mode="dense", min_capacity=0))
    jp = jm.init_medplib(jax.random.PRNGKey(3), jcfg)
    host = jax.tree_util.tree_map(np.array, jp)
    if skew:
        host["llm"]["embed_tokens"]["embedding"][:, 0] += 4.0
        host["llm"]["layers"]["moe"]["router"]["kernel"][:, 0, 0] += 3.0
    cfg = port_cfg(jcfg)
    if lora:
        from medplib_tpu_torch.train import lora as tlora
        from medplib_tpu_torch.utils.convert import tree_to_numpy
        t = convert.tree_from_numpy(host, "cpu")
        gen = torch.Generator().manual_seed(0)
        t["llm"] = tlora.inject(gen, t["llm"],
                                ("q_proj", "v_proj", "o_proj", "down_proj"),
                                4)
        for leaf in tlora._iter_linear_paths(t["llm"]):
            if "lora_b" in leaf[1]:
                leaf[1]["lora_b"].normal_(0, 0.1, generator=gen)
        host = tree_to_numpy(t)
    from medplib_tpu_torch.config import TrainConfig
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                       lora_enable=lora, lora_dropout=0.1 if lora else 0.0,
                       sft_modules=("text_hidden_fcs", "mask_decoder",
                                    "lm_head", "router"))
    batch = ge._make_batch(jcfg, b, 16, np.random.default_rng(1))
    bnp = {k_: np.asarray(getattr(batch, k_)) for k_ in batch._fields
           if getattr(batch, k_) is not None}
    return jcfg, cfg, tcfg, host, bnp


def _single_step(cfg, tcfg, host, bnp, ep_shard=False):
    return jobs.train_step(convert.tree_from_numpy(host, "cpu"), cfg, tcfg,
                           jobs.batch_from_numpy(bnp), ep_shard)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_step(got, want, rtol=1e-3):
    (gm, gb, ga, gd), (wm, wb, wa, wd) = got, want
    assert abs(gm["loss"] - wm["loss"]) <= 1e-5 * abs(wm["loss"])
    assert abs(gm["grad_norm"] - wm["grad_norm"]) <= 1e-4 * wm["grad_norm"]
    assert set(ga) == set(wa)
    du = np.concatenate([(ga[k] - gb[k]).ravel() for k in sorted(ga)])
    dw = np.concatenate([(wa[k] - wb[k]).ravel() for k in sorted(wa)])
    assert _rel(du, dw) < rtol, _rel(du, dw)
    assert len(gd) == len(wd)
    for a, b in zip(gd, wd):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["sort", "einsum"])
@pytest.mark.parametrize("k,shape", [(1, (1, 2, 1)), (2, (1, 2, 1)),
                                     (2, (2, 1, 1))])
def test_capacity_dispatch_matches_one_process(pool2, mode, k, shape):
    """The capacity dispatches of a rank's rows (a skewed router, capacity
    factor 1: tokens drop) return one process's output for the global
    batch, its aux loss and its dropped entries; with ep_shard each rank
    runs its own expert of 2."""
    rng = np.random.default_rng(10 + k)
    e, h, m = 2, 32, 64
    moe = {"router": {"kernel": rng.normal(size=(h, e)).astype(np.float32)},
           "experts": {
               n: {"kernel": (rng.normal(size=(e, a, b)) * a ** -0.5
                              ).astype(np.float32)}
               for n, (a, b) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                                 ("down_proj", (m, h)))}}
    moe["router"]["kernel"][0, 0] += 3.0
    x = rng.normal(size=(4, 9, h)).astype(np.float32)
    x[..., 0] += 2.0
    import medplib_tpu_torch.config as tc
    mcfg = tc.MoeConfig(enable=True, num_experts=e, top_k=k,
                        capacity_factor=1.0, min_capacity=0)
    got = pool2.run(jobs.moe_job, shape, moe, x, mcfg, mode, shape[1] > 1)
    with jobs.count_drops() as drops:
        want, aux = tmoe.moe_mlp(convert.tree_from_numpy(moe, "cpu"),
                                 torch.from_numpy(x), mcfg, train=True,
                                 dispatch_mode=mode)
    for y, a, d in got:
        np.testing.assert_allclose(y, want.numpy(), rtol=1e-5, atol=1e-6)
        assert abs(a - float(aux)) <= 1e-6 * abs(float(aux))
        if mode == "sort":
            assert len(d) == len(drops) == 1 and d[0].sum() > 0
            np.testing.assert_array_equal(d[0], drops[0])


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 2, 2)])
def test_train_step_matches_one_process_and_jax(pool4, shape):
    jcfg, cfg, tcfg, host, bnp = _train_setup()
    got = pool4.run(jobs.train_job, shape, host, cfg, tcfg, bnp, True)
    want = _single_step(cfg, tcfg, host, bnp)
    for g in got:
        assert g[0]["loss"] == got[0][0]["loss"]
    _check_step(got[0], want)
    # the loss of the same params and batch in the JAX package (no dropout)
    nodrop = dataclasses.replace(tcfg, lora_dropout=0.0)
    g0 = pool4.run(jobs.train_job, shape, host, cfg, nodrop, bnp, True)[0]
    jp = jax.tree_util.tree_map(jax.numpy.asarray, host)
    import __graft_entry__ as ge
    jb = ge._make_batch(jcfg, 8, 16, np.random.default_rng(1))
    jl = jax.jit(lambda p, b: jm.model_forward(p, jcfg, b, train=True)
                 ["loss"])(jp, jb)
    assert abs(g0[0]["loss"] - float(jl)) <= 1e-4 * abs(float(jl))


@pytest.mark.parametrize("k,cf,shape", [(1, 1.0, (1, 2, 1)),
                                        (2, 1.0, (1, 2, 1)),
                                        (1, 1.0, (2, 1, 1))])
def test_skewed_router_drops_match_one_process(pool2, k, cf, shape):
    _, cfg, tcfg, host, bnp = _train_setup(k=k, cf=cf, skew=True,
                                           lora=False, b=4)
    got = pool2.run(jobs.train_job, shape, host, cfg, tcfg, bnp,
                    shape[1] > 1)
    want = _single_step(cfg, tcfg, host, bnp)
    assert want[3] and sum(int(d.sum()) for d in want[3]) > 0
    _check_step(got[0], want, rtol=2e-3)
    _check_step(got[1], want, rtol=2e-3)


def test_validate_two_ranks_equals_one(pool2, tmp_path):
    jcfg, cfg, tcfg, host, _ = _train_setup(lora=False)
    import __graft_entry__ as ge
    batches = []
    for seed in (5, 6):
        b = ge._make_batch(jcfg, 4, 16, np.random.default_rng(seed))
        batches.append({k: np.array(getattr(b, k)) for k in b._fields
                        if getattr(b, k) is not None})
    batches[1]["mask_valid"][3] = False
    got = pool2.run(jobs.validate_job, (2, 1, 1), host, cfg, tcfg, batches,
                    str(tmp_path), False)
    from medplib_tpu_torch.train.trainer import Trainer
    tr = Trainer(cfg, tcfg, convert.tree_from_numpy(host, "cpu"),
                 str(tmp_path / "one"))
    want = tr.validate(iter(jobs.batch_from_numpy(b) for b in batches))
    for g in got:
        assert set(g) == set(want)
        for key in want:
            assert abs(g[key] - want[key]) <= 1e-6 * max(abs(want[key]), 1)


def _run_cli(argvs, timeout=TIMEOUT):
    """Spawn one CLI process per argv (PYTHONHASHSEED=0) -> their
    results."""
    ctx = multiprocessing.get_context("spawn")
    res = ctx.Queue()
    old = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        procs = [ctx.Process(target=jobs.cli_rank, args=(a, r, res),
                             daemon=True) for r, a in enumerate(argvs)]
        for p in procs:
            p.start()
    finally:
        if old is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = old
    out = [None] * len(argvs)
    try:
        for _ in argvs:
            r, ok, val = res.get(timeout=timeout)
            assert ok, val
            out[r] = val
    except queue.Empty:
        raise AssertionError("the CLI processes did not finish in time")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return out


def test_train_cli_two_processes(tiny_dataset, tmp_path):  # noqa: F811
    """train/cli.py in 2 processes (gloo, --mesh-data 2, a global batch of
    2, two steps, validation) writes the checkpoint one process writes."""
    from medplib_tpu_torch.utils.checkpoint import CheckpointManager
    data_json, folder = tiny_dataset

    def argv(name, extra):
        return ["--version", "random", "--tokenizer", "fake", "--tiny",
                "--dataset-json", data_json, "--image-folder", folder,
                "--val-data-path", data_json, "--val-batch-size", "2",
                "--exp-name", name, "--log-base-dir", str(tmp_path),
                "--epochs", "1", "--steps-per-epoch", "2",
                "--batch-size", "2", "--model-max-length", "96",
                "--warmup-steps", "1", "--save-steps", "2",
                "--log-steps", "1", "--precision", "fp32",
                "--lora-dropout", "0", "--workers", "0",
                "--device", "cpu"] + extra

    port = dryrun.free_port()
    two = [argv("two", ["--coordinator", f"localhost:{port}",
                        "--num-processes", "2", "--process-id", str(r),
                        "--mesh-data", "2"]) for r in range(2)]
    assert _run_cli(two) == [2, 2]
    assert _run_cli([argv("one", [])]) == [2]
    import json
    logs, trees = [], []
    for name in ("two", "one"):
        with open(tmp_path / name / "scalars.jsonl") as f:
            logs.append({(r["tag"], r["step"]): r["value"]
                         for r in map(json.loads, f)})
        mgr = CheckpointManager(str(tmp_path / name / "ckpt_model"))
        trees.append(torch.load(os.path.join(mgr.directory, "2",
                                             "state.pt"),
                                weights_only=True)["params"])
    # one log (rank 0's), with the one-process run's losses, norms and
    # validation (the step-2 loss follows the step-1 update)
    assert set(logs[0]) == set(logs[1])
    for key, want in logs[1].items():
        if key[0].startswith(("train/", "val/")) and "secs" not in key[0]:
            assert abs(logs[0][key] - want) <= 1e-4 * max(abs(want), 1e-3), \
                key
    from medplib_tpu_torch.utils import tree as tree_util
    flat = [np.concatenate([v.float().numpy().ravel()
                            for v in tree_util.leaves(t)]) for t in trees]
    assert [v.shape for v in tree_util.leaves(trees[0])] == \
        [v.shape for v in tree_util.leaves(trees[1])]
    assert _rel(flat[0], flat[1]) < 1e-5


def test_dryrun_multichip(capsys):
    dryrun.dryrun_multichip(4, timeout=TIMEOUT)
    assert "dryrun_multichip OK" in capsys.readouterr().out


from test_cli import tiny_dataset  # noqa: E402,F401
