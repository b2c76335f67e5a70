"""The port's MPT decoder (medplib_tpu_torch/models/mpt.py) against the
JAX package's (medplib_tpu/models/mpt.py) on the CPU: the JAX init bridged
leaf for leaf through utils/convert, the same token ids from a numpy seed.
float32 throughout (the JAX side at `highest` matmul precision, conftest):
logits within 1e-5 relative and absolute, greedy tokens equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.models import mpt as jmpt
from medplib_tpu_torch.models import mpt as tmpt
from medplib_tpu_torch.utils import convert

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def bridge(tree):
    return convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu")


def port_cfg(c):
    return tmpt.MptConfig(**dataclasses.asdict(c))


def ids(b, t, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t))


def test_config_fields_defaults_and_tiny():
    j, t = jmpt.MptConfig(), tmpt.MptConfig()
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(jmpt.MptConfig.tiny()) == \
        dataclasses.asdict(tmpt.MptConfig.tiny())
    big = tmpt.mpt_7b_config()
    assert (big.d_model, big.n_heads, big.n_layers, big.expansion_ratio,
            big.vocab_size, big.max_seq_len, big.alibi_bias_max) == \
        (4096, 32, 32, 4, 50432, 2048, 8)
    assert big.alibi and big.no_bias


@pytest.mark.parametrize("n_heads", [4, 6, 16, 32])
def test_alibi_slopes_and_bias(n_heads):
    np.testing.assert_array_equal(
        tmpt.alibi_slopes(n_heads, 8, "cpu").numpy(),
        np.asarray(jmpt.alibi_slopes(n_heads, 8)))
    qp, kp = np.arange(3, 9), np.arange(9)
    np.testing.assert_array_equal(
        tmpt.alibi_bias(n_heads, torch.from_numpy(qp),
                        torch.from_numpy(kp)).numpy(),
        np.asarray(jmpt.alibi_bias(n_heads, jnp.asarray(qp),
                                   jnp.asarray(kp))))


def test_init_tree_matches_jax_layout():
    for cfg in (jmpt.MptConfig.tiny(),
                jmpt.MptConfig(d_model=32, n_heads=4, n_layers=3,
                               vocab_size=64, max_seq_len=16, no_bias=True,
                               alibi=True, qk_ln=True)):
        jp = jax.tree_util.tree_map(np.asarray,
                                    jmpt.init_mpt(jax.random.PRNGKey(0), cfg))
        tp = tmpt.init_mpt(torch.Generator().manual_seed(0), port_cfg(cfg),
                           device="cpu")
        jl = {tuple(str(getattr(k, "key", k)) for k in p): v.shape
              for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        from medplib_tpu_torch.utils.tree import leaves_with_paths
        tl = {p: tuple(v.shape) for p, v in leaves_with_paths(tp)}
        assert jl == tl


FORWARD_CASES = {
    "learned_pos": dict(),
    "alibi": dict(alibi=True, learned_pos_emb=False),
    "alibi_6_heads": dict(alibi=True, n_heads=6, d_model=48),
    "no_bias": dict(no_bias=True),
    "clip_qkv": dict(clip_qkv=0.05),
    "qk_ln": dict(qk_ln=True),
    "softmax_scale": dict(softmax_scale=0.3, alibi=True),
    "prefix_lm": dict(prefix_lm=True, alibi=True),
    "pad_mask": dict(alibi=True),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_matches_jax(case):
    over = dict(d_model=64, n_heads=4, n_layers=2, max_seq_len=32,
                vocab_size=96)
    over.update(FORWARD_CASES[case])
    cfg = jmpt.MptConfig(**over)
    jp = jmpt.init_mpt(jax.random.PRNGKey(1), cfg)
    tp = bridge(jp)
    x = ids(2, 10, cfg.vocab_size, seed=3)
    kw_j, kw_t = {}, {}
    if case == "prefix_lm":
        pm = np.zeros((2, 10), bool)
        pm[0, :4], pm[1, :7] = True, True
        kw_j["prefix_mask"], kw_t["prefix_mask"] = jnp.asarray(pm), \
            torch.from_numpy(pm)
    if case == "pad_mask":
        pad = np.ones((2, 10), np.int32)
        pad[1, :3] = 0
        kw_j["pad_mask"], kw_t["pad_mask"] = jnp.asarray(pad), \
            torch.from_numpy(pad)
    want, wc = jax.jit(lambda p, i: jmpt.forward(p, cfg, i, **kw_j))(
        jp, jnp.asarray(x))
    got, gc = tmpt.forward(tp, port_cfg(cfg), torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.k.numpy(), np.asarray(wc.k), **TOL)
    np.testing.assert_allclose(gc.v.numpy(), np.asarray(wc.v), **TOL)


@pytest.mark.parametrize("alibi", [False, True])
def test_incremental_decode_equals_full_forward(alibi):
    """Prefill 7, then 5 tokens one at a time through the cache: each
    step's logits equal the full forward's at that position (1e-5)."""
    cfg = tmpt.MptConfig(d_model=64, n_heads=4, n_layers=2, max_seq_len=32,
                         vocab_size=96, alibi=alibi, qk_ln=True)
    p = tmpt.init_mpt(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(ids(2, 12, cfg.vocab_size, seed=5))
    full, _ = tmpt.forward(p, cfg, x)
    logits, cache = tmpt.forward(p, cfg, x[:, :7])
    steps = [logits[:, -1]]
    for i in range(7, 12):
        logits, cache = tmpt.forward(p, cfg, x[:, i:i + 1], past=cache)
        steps.append(logits[:, -1])
    np.testing.assert_allclose(torch.stack(steps[:-1], 1).numpy(),
                               full[:, 6:11].numpy(), **TOL)
    assert cache.k.shape == (cfg.n_layers, 2, 12, cfg.d_model)


@pytest.mark.parametrize("alibi", [False, True])
def test_greedy_generate_matches_jax(alibi):
    cfg = jmpt.MptConfig(d_model=64, n_heads=4, n_layers=2, max_seq_len=64,
                         vocab_size=96, alibi=alibi,
                         learned_pos_emb=not alibi)
    jp = jmpt.init_mpt(jax.random.PRNGKey(2), cfg)
    tp = bridge(jp)
    x = ids(3, 8, cfg.vocab_size, seed=6)
    want = np.asarray(jmpt.greedy_generate(jp, cfg, jnp.asarray(x), 6))
    got = tmpt.greedy_generate(tp, port_cfg(cfg), torch.from_numpy(x), 6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
