"""Flash attention (kernels K4, K5, K6) on the CPU: the port's plain
versions against the JAX Pallas kernels in interpret mode, as the JAX
package's own tests run them, and the port's autograd function against
torch.autograd through the plain attention. Inputs are made with numpy
from a seed and handed to both sides, in float32.

Tolerance 2e-5 (absolute, on outputs of size ~1): the same f32 math, the
Pallas kernel summing blockwise (online softmax over 16-key blocks here,
so that T = 40 is ragged and several blocks run) and the plain version
over the whole row. Rows that keep no key are checked for finiteness only:
their forward output depends on the block schedule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.ops.pallas import flash_attention as jf
from medplib_tpu_torch.ops import attention as tatt
from medplib_tpu_torch.ops.cuda import flash_attention as tf

torch.set_num_threads(1)
ATOL = 2e-5
BLOCK = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(name):
    """-> (q, k, v, mask or None, live rows [B, T])."""
    rng = np.random.default_rng(CASES.index(name))
    b, h, d = 2, 2, 128
    t, s = {"pad": (40, 40), "nomask": (40, 40), "t_lt_s": (24, 40),
            "ragged": (37, 37), "dead_row": (40, 40)}[name]
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    if name in ("pad", "t_lt_s", "ragged"):
        mask[0, s - 9:] = 0                      # padded tail
    if name == "dead_row":
        mask[1, :5] = 0                          # queries 0..4 keep no key
    rows = np.arange(t)[:, None] + (s - t)
    keep = (rows >= np.arange(s)[None, :])[None] & (mask[:, None, :] > 0)
    return q, k, v, (None if name == "nomask" else mask), keep.any(-1)


CASES = ["pad", "nomask", "t_lt_s", "ragged", "dead_row"]


def _jax_forward(q, k, v, mask):
    jmask = None if mask is None else jnp.asarray(mask)
    return jf._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jmask, BLOCK, BLOCK)


def _port_mask(mask, q, k):
    if mask is None:
        return torch.ones((q.shape[0], k.shape[1]), dtype=torch.int32)
    return _t(mask)


@pytest.mark.parametrize("name", CASES)
def test_flash_forward_plain_matches_pallas(name):
    """out and lse (of the scaled logits) of K4's plain version."""
    q, k, v, mask, live = _case(name)
    b, t, h, _ = q.shape
    out_j, lse_j = _jax_forward(q, k, v, mask)
    out_t, lse_t = tf.flash_forward(_t(q), _t(k), _t(v),
                                    _port_mask(mask, q, k))
    lse_j = np.asarray(lse_j)[:, 0, :t].reshape(b, h, t).transpose(0, 2, 1)
    lse_t = lse_t.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse_t[live], lse_j[live], rtol=0, atol=ATOL)
    assert np.isfinite(out_t.numpy()).all() and np.isfinite(lse_t).all()
    assert (name == "dead_row") == (not live.all())


@pytest.mark.parametrize("name", CASES)
def test_flash_backward_plain_matches_pallas(name):
    """dq (K5) and dk, dv (K6) of the plain versions against
    _flash_backward's two Pallas passes, each side from its own forward
    (rows that keep no key get zero gradient on both)."""
    q, k, v, mask, _ = _case(name)
    g = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    out_j, lse_j = _jax_forward(q, k, v, mask)
    jmask = None if mask is None else jnp.asarray(mask)
    want = jf._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jmask, out_j, lse_j, jnp.asarray(g), BLOCK,
                              BLOCK)
    tm = _port_mask(mask, q, k)
    out_t, lse_t = tf.flash_forward(_t(q), _t(k), _t(v), tm)
    delta = (_t(g) * out_t).sum(-1).transpose(1, 2).contiguous()
    dq = tf.flash_dq(_t(q), _t(k), _t(v), tm, _t(g), lse_t, delta)
    dk, dv = tf.flash_dkv(_t(q), _t(k), _t(v), tm, _t(g), lse_t, delta)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def test_flash_vjp_matches_pallas_custom_vjp():
    """The port's flash_attention under torch.autograd against jax.vjp of
    the JAX package's flash_attention (its custom_vjp, default blocks)."""
    import jax
    q, k, v, mask, _ = _case("pad")
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, b, c: jf.flash_attention(
        a, b, c, jnp.asarray(mask)), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    out_t = tf.flash_attention(qt, kt, vt, _t(mask))
    got = torch.autograd.grad(out_t, (qt, kt, vt), _t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=ATOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("with_mask", [True, False])
def test_flash_autograd_matches_plain_attention(with_mask):
    """FlashAttention (forward K4, backward delta + K5 + K6; plain versions
    on the CPU) against torch.autograd through ops/attention's plain
    path, with an all-ones mask standing in for None. 1e-5: both f32."""
    q, k, v, mask, _ = _case("t_lt_s")
    mask = mask if with_mask else None
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    grads = []
    for fn in ("flash", "plain"):
        qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
        m = None if mask is None else _t(mask)
        if fn == "flash":
            out = tf.flash_attention(qt, kt, vt, m)
        else:
            bias = tatt.make_causal_bias(m, q.shape[1], k.shape[1])
            out = tatt._plain_attention(qt, kt, vt, bias)
        grads.append((out,) + torch.autograd.grad(out, (qt, kt, vt), _t(g)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [1024, 687, 64])
def test_causal_attention_takes_plain_path_on_cpu(monkeypatch, t):
    """The flash route needs a CUDA tensor: on the CPU a prompt with
    head_dim 128 runs the plain attention at any length (1024, the serving
    cell's 687, 64), and the plain route counts the call."""
    def fail(*a, **k):
        raise AssertionError("flash attention on the CPU")
    monkeypatch.setattr(tatt, "flash_attention", fail)
    monkeypatch.setattr(tf, "flash_attention", fail)
    q = torch.zeros((1, t, 1, 128))
    mask = torch.ones((1, t), dtype=torch.int32)
    mask[0, t - 5:] = 0
    n0 = tatt.causal_attention.plain_calls
    assert tatt.causal_attention(q, q, q, mask).shape == q.shape
    assert tatt.causal_attention.plain_calls == n0 + 1


def test_flash_wrappers_reject_bad_shapes():
    q = torch.zeros((1, 8, 2, 128))
    k = torch.zeros((1, 4, 2, 128))
    with pytest.raises(ValueError, match="S >= T"):
        tf.flash_forward(q, k, k, torch.ones((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="mask"):
        tf.flash_forward(q, q, q, torch.ones((1, 7), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        tf.flash_attention(q, q, q, causal=False)
