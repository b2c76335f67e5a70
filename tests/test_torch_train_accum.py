"""Gradient accumulation of the port's train step against the JAX package's
`make_train_step`, on the CPU.

The JAX step sums the microbatch gradients in three ways: one microbatch
is a direct call; up to MEDPLIB_TRAIN_UNROLL_MAX (8) microbatches, or with
MEDPLIB_TRAIN_UNROLL_GA set, an unrolled sum in each leaf's dtype; above
that, or with MEDPLIB_TRAIN_FORCE_SCAN, a scan that sums into f32 zeros,
so bf16 leaves get f32 gradients and the optimizer's moments of those
leaves turn f32. The port takes the same path under the same environment
(`trainer.accumulation_path`).

The model is MedplibConfig.tiny() in the stage-3 QLoRA form of
tests/test_torch_train_slice.py (LLaMA int8, LoRA q/v r=8 with bf16
adapters, sft heads f32, dropout 0), two updates at ga = 2 (unrolled) and
ga = 9 (scan), each microbatch one row.

Tolerances. Loss 1e-5 relative, grad_norm 1e-4 relative (f32 sums in
another order). Moments: the dtype of every mu / nu leaf equal to JAX's;
the values within 2e-4 of the leaf's largest entry (f32 backward summed in
another order, as the gradient test of test_torch_train_slice.py), at
least that test's 1e-7 floor (1e-14 for nu, on the scale of g * g: leaves
whose gradient is zero in exact arithmetic hold f32 noise), plus,
where the microbatch gradients are bf16, one bf16 rounding step of the
leaf's largest entry (2^-8: a gradient that lands next to a rounding
boundary rounds the other way), twice that for nu (g * g). Parameters: the updates of test_torch_train_slice.py's
two-step test (every element within 1e-5 = lr / 100, relative Frobenius
error <= 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import medplib as jm
from medplib_tpu.train import lora as jlora
from medplib_tpu.train import trainer as jtr
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.train import trainer as ttr
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import tree as tree_util

torch.set_num_threads(1)
ENV = ("MEDPLIB_TRAIN_FORCE_SCAN", "MEDPLIB_TRAIN_UNROLL_GA",
       "MEDPLIB_TRAIN_UNROLL_MAX")


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def bridge(tree):
    return convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def model():
    cfg = jc.MedplibConfig.tiny()
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    p["llm"] = jq.quantize_tree(p["llm"])
    p["llm"] = jlora.inject(jax.random.PRNGKey(1), p["llm"],
                            ("q_proj", "v_proj"), r=8)
    for n in ("q_proj", "v_proj"):
        node = p["llm"]["layers"]["attn"][n]
        node["lora_b"] = (jax.random.normal(jax.random.PRNGKey(2),
                                            node["lora_b"].shape)
                          * 0.02).astype(node["lora_b"].dtype)
    assert node["lora_b"].dtype == jnp.bfloat16
    return cfg, p


def _batches(cfg, ga):
    """ga one-row microbatches stacked on a leading axis: (JAX, port)."""
    mbs = [ge._make_batch(cfg, B=1, T=16, rng=np.random.default_rng(i))
           for i in range(ga)]
    jb = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *mbs)
    tb = tm.Batch(**{k: torch.from_numpy(np.stack(
        [np.asarray(getattr(mb, k)) for mb in mbs]))
        for k in tm.Batch._fields})
    return jb, tb


def _tcfg(ga):
    return jc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          lora_dropout=0.0, grad_accumulation_steps=ga)


_JAX = {}


def _jax_steps(model, ga):
    """Two JAX updates at ga under the default environment (cached)."""
    if ga not in _JAX:
        cfg, p = model
        jcfg = _tcfg(ga)
        state, tx = jtr.create_state(p, jcfg)
        step = jax.jit(jtr.make_train_step(cfg, jcfg, tx))
        jb, _ = _batches(cfg, ga)
        for _ in range(2):
            state, metrics = step(state, jb)
        _JAX[ga] = (state, metrics)
    return _JAX[ga]


def _port_steps(model, ga):
    cfg, p = model
    jcfg = _tcfg(ga)
    tp = bridge(p)
    tstate, ttx = ttr.create_state(tp, port_cfg(jcfg))
    tstep = ttr.make_train_step(port_cfg(cfg), port_cfg(jcfg), ttx)
    _, tb = _batches(cfg, ga)
    for _ in range(2):
        tstate, tmetrics = tstep(tstate, tb)
    return tp, ttx, tstate, tmetrics


def _jax_moments(state):
    """mu / nu of the trainable leaves, in leaf order (optax.masked keeps
    the full tree with MaskedNode at frozen leaves)."""
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    assert len(adam) == 1
    leaves = lambda t: [x for x in jax.tree_util.tree_leaves(t)
                        if hasattr(x, "dtype")]
    return leaves(adam[0].mu), leaves(adam[0].nu)


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("ga", [2, 9])
def test_accumulation_matches_jax(model, ga):
    """Two updates at ga = 2 (unrolled, bf16 sums for bf16 leaves) and
    ga = 9 (the f32 scan): loss, grad_norm, the moments' values AND
    dtypes, and the parameter updates."""
    assert ttr.accumulation_path(ga) == ("unrolled" if ga <= 8 else "scan")
    state, metrics = _jax_steps(model, ga)
    tp, ttx, tstate, tmetrics = _port_steps(model, ga)
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    mask = tree_util.leaves(ttx.mask)
    old = tree_util.leaves(tp)
    trainable = [o for o, m in zip(old, mask) if m]
    jmu, jnu = _jax_moments(state)
    assert len(jmu) == len(tstate.opt_state.mu) == len(trainable)
    kinds = set()
    for p0, tmu, tnu, wmu, wnu in zip(trainable, tstate.opt_state.mu,
                                      tstate.opt_state.nu, jmu, jnu):
        assert (_dtype(tmu), _dtype(tnu)) == (str(wmu.dtype),
                                             str(wnu.dtype))
        kinds.add((_dtype(p0), _dtype(tmu)))
        for got, want, steps, floor in ((tmu, wmu, 1, 1e-7),
                                        (tnu, wnu, 2, 1e-14)):
            w = np.asarray(want, np.float32)
            big = float(np.abs(w).max())
            tol = max(2e-4 * big, floor)
            if p0.dtype == torch.bfloat16:   # bf16 microbatch gradients
                tol += steps * 2.0 ** -8 * big
            assert np.all(np.abs(got.float().numpy() - w) <= tol)
    # bf16 leaves keep bf16 moments in the unrolled sum, turn f32 in the
    # scan; f32 leaves stay f32
    bf16_mu = "bfloat16" if ga <= 8 else "float32"
    assert ("bfloat16", bf16_mu) in kinds and ("float32", "float32") in kinds
    want = jax.tree_util.tree_leaves(state.params)
    num = den = 0.0
    for g, o, w, m in zip(tree_util.leaves(tstate.params), old, want, mask):
        if not m:
            assert g is o
            continue
        dp = g.float().numpy() - o.float().numpy()
        dj = np.asarray(w, np.float32) - o.float().numpy()
        assert np.abs(dp - dj).max() <= 1e-5
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def test_unrolled_sum_at_ga9_differs_from_jax(model, monkeypatch):
    """The port before this repair summed every ga in the leaf dtype. With
    the unrolled path forced at ga = 9 (MEDPLIB_TRAIN_UNROLL_MAX=9, the
    JAX step left at its default scan), the bf16 leaves' moments are bf16
    where JAX's are f32: the dtype alone shows the difference."""
    state, _ = _jax_steps(model, 9)
    monkeypatch.setenv("MEDPLIB_TRAIN_UNROLL_MAX", "9")
    assert ttr.accumulation_path(9) == "unrolled"
    _, ttx, tstate, _ = _port_steps(model, 9)
    jmu, _ = _jax_moments(state)
    got = [_dtype(m) for m in tstate.opt_state.mu]
    want = [str(m.dtype) for m in jmu]
    assert "bfloat16" in got and "bfloat16" not in want and got != want


@pytest.mark.parametrize("env,ga,path", [
    ({}, 1, "direct"), ({}, 8, "unrolled"), ({}, 9, "scan"),
    ({"MEDPLIB_TRAIN_FORCE_SCAN": "1"}, 1, "scan"),
    ({"MEDPLIB_TRAIN_FORCE_SCAN": "1"}, 2, "scan"),
    ({"MEDPLIB_TRAIN_UNROLL_GA": "1"}, 16, "unrolled"),
    ({"MEDPLIB_TRAIN_UNROLL_MAX": "4"}, 5, "scan"),
    ({"MEDPLIB_TRAIN_UNROLL_MAX": "4"}, 4, "unrolled"),
])
def test_accumulation_path_reads_the_jax_environment(monkeypatch, env, ga,
                                                     path):
    """The variables and defaults of medplib_tpu/train/trainer.py's
    make_train_step choose the same path."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ttr.accumulation_path(ga) == path
