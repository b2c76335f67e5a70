"""Sampled decode of medplib_tpu_torch against the JAX package on the CPU.

The filter (temperature, top-p, greedy rows) and the draw
argmax(filtered + g) are held to jax.jit(medplib_tpu.ops.sampling.
sample_token) token for token, with JAX's own Gumbel noise
(jax.random.gumbel of each row's threefry subkey, as jax.random.categorical
draws it) injected into the port through its noise function: the port's
streams are counter-based integer hashes and cannot reproduce threefry.
The port's own stream is then held to the filtered softmax by a chi-square
test, and to row invariance and seed determinism. Token tests are exact;
inputs keep every cumulative sum at least 1e-5 away from the top-p cutoff,
(f32 sums of 257 terms err by ~1e-7), so no keep decision can flip.

`generate(do_sample=True)` end to end: the tiny float32 model of
MedplibConfig.tiny(), per-row temperatures (one row greedy) and top_p,
JAX's noise injected at every step; tokens must equal jax.jit(generate)'s
and the masks agree within rel 1e-4 (float32, no activation quant).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import __graft_entry__ as ge
import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import medplib as jm
from medplib_tpu.ops import sampling as js
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.ops import sampling as ts
from medplib_tpu_torch.utils import convert

torch.set_num_threads(1)


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


@jax.jit
def _jax_gumbel(subkeys, n_dummy):
    return jax.vmap(lambda k: jax.random.gumbel(k, n_dummy.shape))(subkeys)


def jax_noise(subkeys, v):
    return np.asarray(_jax_gumbel(subkeys, jnp.zeros((v,))))


def inject(monkeypatch, by_step):
    """Make the port's draw use by_step[step] (a [B, V] array) for step
    keys whose counter is `step`."""
    def noise(keys, n):
        steps = keys[:, 1].unique()
        assert steps.numel() == 1
        g = by_step[int(steps[0])]
        assert g.shape == (keys.shape[0], n)
        return torch.from_numpy(np.array(g))
    monkeypatch.setattr(ts, "gumbel_rows", noise)


def _logits(rng, b, v):
    """Random logits whose top-p cumulative sums stay clear of the cutoffs
    used below; row 3 holds ties (a block of equal top logits)."""
    x = (rng.normal(size=(b, v)) * 2.0).astype(np.float32)
    x[3, :6] = x[3].max() + 1.0
    return x


CASES = {
    "per_row_t_and_p": (np.array([0.7, 1.0, 1.3, 0.5, 2.0, 0.9], np.float32),
                        np.array([0.9, 0.5, 1.0, 0.3, 0.95, 0.8],
                                 np.float32)),
    "greedy_rows": (np.array([0.0, 5e-5, 1.0, 0.8, 1e-4, 0.0], np.float32),
                    np.float32(0.9)),
    "top_p_zero": (np.float32(1.0), np.float32(0.0)),
    "scalar": (np.float32(0.8), np.float32(0.95)),
}


def _cum_clear(x, t, p, margin=1e-5):
    t = np.broadcast_to(np.asarray(t, np.float32).reshape(-1, 1)
                        if np.ndim(t) else t, (x.shape[0], 1))
    p = np.broadcast_to(np.asarray(p, np.float32).reshape(-1)
                        if np.ndim(p) else p, (x.shape[0],))
    for r in range(x.shape[0]):
        if t[r, 0] < 1e-4:
            continue
        s = np.sort(x[r] / max(t[r, 0], 1e-6))[::-1].astype(np.float64)
        pr = np.exp(s - s.max())
        pr /= pr.sum()
        before = (np.cumsum(pr) - pr)[1:]    # the top token is always kept
        if np.min(np.abs(before - p[r])) < margin:
            return False
    return True


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_token_matches_jax_with_injected_noise(case, monkeypatch):
    b, v = 6, 257
    t, p = CASES[case]
    for seed in range(20):
        x = _logits(np.random.default_rng(seed), b, v)
        if _cum_clear(x, t, p):
            break
    assert _cum_clear(x, t, p)
    jt = jnp.asarray(t.reshape(-1, 1) if np.ndim(t) else t)
    jp = jnp.asarray(p.reshape(-1, 1) if np.ndim(p) else p)
    for step in range(3):
        keys = js.row_keys(jax.random.PRNGKey(seed), b)
        for _ in range(step + 1):
            keys, sub = js.split_rows(keys)
        want = np.asarray(jax.jit(js.sample_token)(sub, jnp.asarray(x),
                                                   jt, jp))
        inject(monkeypatch, {0: jax_noise(sub, v)})
        got = ts.sample_token(ts.row_keys(0, b, "cpu"), torch.from_numpy(x),
                              torch.from_numpy(np.array(t))
                              if np.ndim(t) else float(t),
                              torch.from_numpy(np.array(p))
                              if np.ndim(p) else float(p))
        np.testing.assert_array_equal(got.numpy(), want)
    if case == "greedy_rows":
        np.testing.assert_array_equal(got.numpy()[[0, 1, 5]],
                                      x.argmax(-1)[[0, 1, 5]])


def test_top_p_keeps_tied_logits(monkeypatch):
    """The cutoff is by value: with top_p tiny, every logit tied with the
    top one stays drawable (and no other)."""
    x = np.full((1, 16), -3.0, np.float32)
    x[0, [2, 7, 11]] = 5.0
    seen = set()
    for s in range(200):
        keys = ts.row_keys(s, 1, "cpu")
        seen.add(int(ts.sample_token(keys, torch.from_numpy(x), 1.0,
                                     1e-6)[0]))
    assert seen == {2, 7, 11}


def test_chi_square_against_filtered_softmax():
    """The port's own stream: 40,000 draws of one row (one seed per draw)
    against softmax(x / t) renormalized over the top-p set."""
    x = np.array([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -4.0]], np.float32)
    t, p = 0.9, 0.9
    s = x[0] / t
    pr = np.exp(s - s.max())
    pr /= pr.sum()
    order = np.argsort(-s)
    keep = (np.cumsum(pr[order]) - pr[order]) < p
    want = np.zeros_like(pr)
    want[order[keep]] = pr[order[keep]]
    want /= want.sum()
    n = 40000
    keys = ts.row_keys(torch.arange(n), n, "cpu")
    draws = ts.sample_token(keys, torch.from_numpy(np.repeat(x, n, 0)), t,
                            p).numpy()
    counts = np.bincount(draws, minlength=x.shape[1])
    assert set(np.nonzero(counts)[0]) <= set(order[keep])
    nz = want > 0
    chi2, pval = stats.chisquare(counts[nz], want[nz] * n)
    assert pval > 1e-3, (chi2, pval, counts, want * n)


def test_row_noise_is_batch_invariant_and_seeded():
    """Row r's noise depends on its seed and step only: the same at B=1 and
    at B=4, the same for the same seed, other for another seed or step."""
    seeds = torch.tensor([11, 12, 13, 14])
    k4 = ts.row_keys(seeds, 4, "cpu")
    for r in range(4):
        k1 = ts.row_keys(seeds[r:r + 1], 1, "cpu")
        np.testing.assert_array_equal(ts.gumbel_rows(k1, 300)[0].numpy(),
                                      ts.gumbel_rows(k4, 300)[r].numpy())
    a = ts.gumbel_rows(ts.row_keys(seeds, 4, "cpu"), 300)
    assert torch.equal(a, ts.gumbel_rows(ts.row_keys(seeds, 4, "cpu"), 300))
    assert not torch.equal(a, ts.gumbel_rows(
        ts.row_keys(seeds + 100, 4, "cpu"), 300))
    nxt, sub = ts.split_rows(k4)
    assert torch.equal(sub, k4) and torch.equal(nxt[:, 1], k4[:, 1] + 1)
    assert not torch.equal(ts.gumbel_rows(nxt, 300), a)
    # an int seed gives every row its own stream; a [B, 2] state passes
    one = ts.row_keys(7, 3, "cpu")
    assert one[:, 0].unique().numel() == 3
    assert ts.row_keys(one, 3, "cpu") is one
    # the noise is a standard Gumbel: mean ~ 0.5772, var ~ pi^2 / 6
    g = ts.gumbel_rows(ts.row_keys(torch.arange(64), 64, "cpu"),
                       4096).double()
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


def test_per_row_values_do_not_copy_device_tensors():
    t = torch.tensor([0.5, 1.0])
    assert ts.per_row(t, "cpu").shape == (2, 1)
    assert ts.per_row(0.7, "cpu").shape == (1, 1)
    col = torch.tensor([[0.5], [1.0]])
    assert ts.per_row(col, "cpu") is col


@pytest.fixture(scope="module")
def tiny_model():
    cfg = jc.MedplibConfig.tiny()
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    p["llm"]["embed_tokens"]["embedding"] = \
        p["llm"]["embed_tokens"]["embedding"] * 50.0
    host = jax.tree_util.tree_map(np.asarray, p)
    return cfg, p, convert.tree_from_numpy(host, device="cpu")


def _torch_batch(batch):
    return tm.Batch(**{k: torch.from_numpy(np.array(getattr(batch, k)))
                       for k in tm.Batch._fields})


def test_generate_sampled_matches_jax_with_injected_noise(tiny_model,
                                                          monkeypatch):
    cfg, jp, tp = tiny_model
    b, new = 4, 6
    batch = ge._make_batch(cfg, b, 12, np.random.default_rng(0))
    t = np.array([0.8, 0.0, 1.2, 0.6], np.float32)      # row 1 greedy
    p = np.array([0.9, 1.0, 0.7, 0.95], np.float32)
    base = jax.random.PRNGKey(3)
    want = jax.jit(lambda pp, bb: jm.generate(
        pp, cfg, bb, max_new_tokens=new, eos_id=-1, do_sample=True,
        temperature=jnp.asarray(t[:, None]), top_p=jnp.asarray(p[:, None]),
        rng=base))(jp, batch)
    keys = js.row_keys(base, b)
    by_step = {}
    for step in range(new + 1):
        keys, sub = js.split_rows(keys)
        by_step[step] = jax_noise(sub, cfg.vocab_size_padded)
    inject(monkeypatch, by_step)
    got = tm.generate(tp, port_cfg(cfg), _torch_batch(batch),
                      max_new_tokens=new, eos_id=-1, do_sample=True,
                      temperature=torch.from_numpy(t),
                      top_p=torch.from_numpy(p), rng=[5, 6, 7, 8])
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.has_seg.numpy(),
                                  np.asarray(want.has_seg))
    pm, wm = got.pred_masks.numpy(), np.asarray(want.pred_masks)
    assert np.linalg.norm(pm - wm) / np.linalg.norm(wm) < 1e-4


def test_generate_sampled_is_seeded_per_row(tiny_model):
    """The port's own stream in generate: the same seeds repeat the same
    tokens; a row's tokens do not depend on the rows beside it; a greedy
    row (t = 0) equals greedy decoding."""
    cfg, _, tp = tiny_model
    pc = port_cfg(cfg)
    batch = _torch_batch(ge._make_batch(cfg, 3, 12,
                                        np.random.default_rng(1)))
    t = torch.tensor([1.5, 0.0, 1.5])

    def run(bb, seeds, temps):
        return tm.generate(tp, pc, bb, max_new_tokens=6, eos_id=-1,
                           do_sample=True, temperature=temps, top_p=0.95,
                           rng=seeds).output_ids

    a = run(batch, [1, 2, 3], t)
    assert torch.equal(a, run(batch, [1, 2, 3], t))
    one = tm.Batch(*[None if x is None else x[2:3] for x in batch])
    assert torch.equal(run(one, [3], t[2:3])[0], a[2])
    greedy = tm.generate(tp, pc, batch, max_new_tokens=6,
                         eos_id=-1).output_ids
    assert torch.equal(a[1], greedy[1])
    other = run(batch, [101, 102, 103], t)
    assert not torch.equal(other[[0, 2]], a[[0, 2]])
