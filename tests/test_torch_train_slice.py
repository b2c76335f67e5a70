"""The ported training slice end to end on the CPU, against the JAX package
on the same params and batch: model_forward's losses and the gradients of
every trainable leaf (jax.grad), two make_train_step updates, and the
port's Trainer.fit with checkpoint, resume and skip-replay.

The model is MedplibConfig.tiny() in the stage-3 QLoRA form: LLaMA
int8-quantized, LoRA q/v r=8 injected after, sft heads trainable, LoRA
dropout 0. Float32 throughout. The CPU takes the plain attention on both
sides (the JAX package routes to flash only on its accelerator).

Tolerances: losses 1e-5 relative; gradients 2e-4 of each leaf's largest
entry (f32 backward through ~20 ops summed in another order, through
int8-dequantized kernels) but at least 1e-7 (leaves whose gradient is zero
in exact arithmetic, like a key bias under softmax, hold f32 noise of
~1e-10), plus one bf16 rounding step for the bf16 adapters beside the int8
kernels. Parameter updates after two steps (lr = 1e-3): relative
Frobenius error over all trainable leaves <= 1e-3 (4e-5 measured) and
every element within 1e-5 = lr / 100, because Adam's normalized step
u = m / (sqrt(v) + 1e-8) turns f32 noise in a near-zero gradient (or one
that is zero in exact arithmetic, like a key bias under softmax) into a
visible fraction of lr."""

import dataclasses

import jax
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
from medplib_tpu_torch.train import lora as tlora
from medplib_tpu_torch.train import trainer as ttr
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import tree as tree_util

torch.set_num_threads(1)
SFT = jc.TrainConfig().sft_modules


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def bridge(tree):
    return convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu")


def torch_batch(batch, lead=False):
    b = tm.Batch(**{k: torch.from_numpy(np.array(getattr(batch, k)))
                    for k in tm.Batch._fields})
    return tm.Batch(*[x[None] for x in b]) if lead else b


@pytest.fixture(scope="module")
def model():
    cfg = jc.MedplibConfig.tiny()
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    p["llm"] = jq.quantize_tree(p["llm"])
    p["llm"] = jlora.inject(jax.random.PRNGKey(1), p["llm"],
                            ("q_proj", "v_proj"), r=8)
    # non-zero lora_b, so that lora_a gets a gradient too
    for n in ("q_proj", "v_proj"):
        node = p["llm"]["layers"]["attn"][n]
        node["lora_b"] = (jax.random.normal(jax.random.PRNGKey(2),
                                            node["lora_b"].shape)
                          * 0.02).astype(node["lora_b"].dtype)
    batch = ge._make_batch(cfg, B=2, T=16, rng=np.random.default_rng(0))
    return cfg, p, batch


def _paths(tree):
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_model_forward_losses_and_grads_match_jax(model):
    """Every scalar of model_forward and the gradient of every trainable
    leaf, remat on and off on the port side (JAX with remat)."""
    cfg, p, batch = model
    mask = jlora.trainable_mask(p, SFT)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    m_lv = jax.tree_util.tree_leaves(mask)
    train = [x for x, m in zip(leaves, m_lv) if m]
    paths = [pp for pp, m in zip(_paths(p), m_lv) if m]

    def loss(tlv):
        it = iter(tlv)
        full = treedef.unflatten([next(it) if m else x
                                  for x, m in zip(leaves, m_lv)])
        out = jm.model_forward(full, cfg, batch, train=True, remat=True)
        return out["loss"], {k: v for k, v in out.items() if v.ndim == 0}

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        train)
    for remat in (True, False):
        tp = bridge(p)
        tmask = tlora.trainable_mask(tp, SFT)
        tl = [x.requires_grad_(True) for x, m in zip(
            tree_util.leaves(tp), tree_util.leaves(tmask)) if m]
        assert [pp for pp, m in zip(tree_util.leaves_with_paths(tp),
                                    tree_util.leaves(tmask)) if m] \
            and len(tl) == len(train)
        out = tm.model_forward(tp, port_cfg(cfg), torch_batch(batch),
                               remat=remat)
        assert set(out) == set(jout)
        for k, v in jout.items():
            np.testing.assert_allclose(float(out[k].detach()), float(v),
                                       rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        tg = torch.autograd.grad(out["loss"], tl, allow_unused=True)
        for path, g, w, x in zip(paths, tg, jgrads, tl):
            w = np.asarray(w, np.float32)
            g = np.zeros_like(w) if g is None else g.float().numpy()
            tol = max(2e-4 * float(np.abs(w).max()), 1e-7)
            if x.dtype == torch.bfloat16:    # plus one bf16 rounding step
                tol = tol + 2.0 ** -7 * np.abs(w)
            assert np.all(np.abs(g - w) <= tol), (remat, path)


def test_two_train_steps_match_jax(model):
    """Two make_train_step updates (the first at lr 0). Frozen leaves stay
    the same tensors; the updates of the trainable ones agree."""
    cfg, p, batch = model
    jcfg = jc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          lora_dropout=0.0)
    state, tx = jtr.create_state(p, jcfg)
    step = jax.jit(jtr.make_train_step(cfg, jcfg, tx))
    batches = jax.tree_util.tree_map(lambda x: x[None], batch)
    tp = bridge(p)
    tstate, ttx = ttr.create_state(tp, port_cfg(jcfg))
    tstep = ttr.make_train_step(port_cfg(cfg), port_cfg(jcfg), ttx)
    tb = torch_batch(batch, lead=True)
    for _ in range(2):
        state, metrics = step(state, batches)
        tstate, tmetrics = tstep(tstate, tb)
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    assert tstate.step == 2 and tstate.opt_state.count == 2
    mask = tree_util.leaves(ttx.mask)
    old = tree_util.leaves(tp)
    want = jax.tree_util.tree_leaves(state.params)
    num = den = 0.0
    for g, o, w, m in zip(tree_util.leaves(tstate.params), old, want, mask):
        if not m:
            assert g is o                       # frozen: the same tensor
            continue
        dp = g.float().numpy() - o.float().numpy()
        dj = np.asarray(w, np.float32) - o.float().numpy()
        assert np.abs(dp - dj).max() <= 1e-5
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3


def _make_batches(cfg, n):
    return [torch_batch(ge._make_batch(cfg, B=2, T=16,
                                       rng=np.random.default_rng(i)),
                        lead=True) for i in range(n)]


def test_trainer_fit_resume_and_skip_replay(model, tmp_path):
    """Two steps and a checkpoint, then a new Trainer resumes at step 2,
    skips the two consumed batches and takes the third: the same params as
    three steps in one run. The JSONL log holds the scalars."""
    cfg, p, _ = model
    pc = port_cfg(cfg)
    batches = _make_batches(cfg, 3)
    consumed = []

    def iterator():
        def gen():
            for i, b in enumerate(batches):
                consumed.append(i)
                yield b
        return gen()

    def tcfg(spe):
        return tc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                              epochs=1, steps_per_epoch=spe, save_steps=1,
                              log_steps=1, lora_dropout=0.1)

    ref = ttr.Trainer(pc, tcfg(3), bridge(p), str(tmp_path / "ref"))
    assert ref.fit(iterator) == 3
    first = ttr.Trainer(pc, tcfg(2), bridge(p), str(tmp_path / "run"))
    assert first.fit(iterator) == 2
    assert first.ckpt.latest_step() == 2
    consumed.clear()
    resumed = ttr.Trainer(pc, tcfg(3), bridge(p), str(tmp_path / "run"))
    assert resumed.fit(iterator) == 3
    assert consumed == [0, 1, 2]
    assert resumed.state.opt_state.count == 3
    for a, b in zip(tree_util.leaves(resumed.state.params),
                    tree_util.leaves(ref.state.params)):
        assert torch.equal(a, b)
    log = (tmp_path / "run" / "scalars.jsonl").read_text().splitlines()
    assert any('"train/loss"' in line for line in log)


def test_trainer_loader_fault_budget(model, tmp_path):
    """A loader that fails is re-opened; the fourth failure in an epoch
    aborts. train_mask_decoder=False freezes the mask decoder."""
    cfg, p, _ = model
    pc = dataclasses.replace(port_cfg(cfg), seg=dataclasses.replace(
        port_cfg(cfg).seg, train_mask_decoder=False))
    batch = _make_batches(cfg, 1)[0]
    fails = {"n": 2}

    def flaky():
        def gen():
            if fails["n"] > 0:
                fails["n"] -= 1
                raise OSError("loader")
            while True:
                yield batch
        return gen()

    t = ttr.Trainer(pc, tc.TrainConfig(epochs=1, steps_per_epoch=1,
                                       lora_dropout=0.0),
                    bridge(p), str(tmp_path / "a"))
    assert not any(tree_util.leaves(t.tx.mask["sam"]["mask_decoder"]))
    assert t.fit(flaky) == 1
    fails["n"] = 10
    t2 = ttr.Trainer(pc, tc.TrainConfig(epochs=1, steps_per_epoch=1),
                     bridge(p), str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="4 times"):
        t2.fit(flaky)
