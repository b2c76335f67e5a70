"""The arithmetic of the bf16 tensor-core flash kernels (flash_fwd_mma_kernel,
flash_dq_mma_kernel and flash_dkv_mma_kernel, K4 / K5 / K6, in
medplib_tpu_torch/csrc/flash_attention.cu), modelled on the CPU.

The kernels run every product as bf16 mma.sync with f32 sums: q, k, v and
dO are bf16 values, exact as operands; the scores S = Q K^T and dP = dO V^T
are f32 sums of exact products; the scale multiplies the f32 score sum. P
and dS are not bf16 values, so each is split, hi = bf16(x),
lo = bf16(x - hi), and both halves are multiplied (f32 sums) into P V (K4,
with the online softmax over 64-key tiles), dS K * scale (K5),
dV = P^T dO and dK = dS^T Q * scale (K6). The models below do the same in
float32 torch on the CPU. They are held to the JAX package's Pallas kernels
(`_flash_forward` / `_flash_backward`, interpret mode, small blocks, as
tests/test_torch_flash.py runs them) and, at the training sequence length,
to the port's plain versions: rel Frobenius 1e-3, the tolerance the
kernels are held to on the card. A single bf16 rounding of dS (K5, K6) and
P (K6), the trap the split avoids, is shown to fail that tolerance at that
length; for K4's P its size is asserted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.ops.pallas import flash_attention as jf
from medplib_tpu_torch.ops.cuda import flash_attention as tf

torch.set_num_threads(1)
BLOCK = 16


def _bf16(a):
    """numpy f32 -> the nearest bf16 values, as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float()


def _round(x, split):
    """The A operand as the kernel feeds it: hi + lo bf16 halves (split),
    or one bf16 rounding."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def dkv_model(q, k, v, mask, dout, lse, delta, split=True):
    """K6's arithmetic on bf16-valued f32 inputs q, dout [B, T, H, D],
    k, v [B, S, H, D], mask [B, S], lse, delta [B, H, T] -> (dK, dV) in
    f32, before the output's bf16 rounding."""
    scale = q.shape[-1] ** -0.5
    keep = tf._keep(mask, q.shape[1], k.shape[1])              # [B,1,T,S]
    s = torch.einsum("bshd,bthd->bhst", k, q) * scale          # S^T
    p = torch.where(keep.transpose(-1, -2),
                    torch.exp(s - lse[:, :, None, :]), torch.zeros(()))
    dp = torch.einsum("bshd,bthd->bhst", v, dout)              # dP^T
    ds = p * (dp - delta[:, :, None, :])
    dv = sum(torch.einsum("bhst,bthd->bshd", x, dout)
             for x in _round(p, split))
    dk = sum(torch.einsum("bhst,bthd->bshd", x, q)
             for x in _round(ds, split)) * scale
    return dk, dv


def fwd_model(q, k, v, mask, split=True):
    """K4's arithmetic on bf16-valued f32 inputs -> (out [B, T, H, D],
    lse [B, H, T]) in f32, before the output's bf16 rounding: per 64-query
    tile, an online softmax over the 64-key tiles its last row reaches
    (keys past S zero and not kept, masked scores the finite NEG_INF), the
    scale on the f32 score sum, l summed from the f32 P, and P V from P's
    hi + lo halves (split) or one bf16 rounding."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    scale, q_off, tile = d ** -0.5, s_len - t, 64
    n_tiles = -(-s_len // tile)
    pad = n_tiles * tile - s_len
    kp, vp = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v))
    keep = torch.nn.functional.pad(tf._keep(mask, t, s_len), (0, pad))
    out = torch.empty((b, t, h, d))
    lse = torch.empty((b, h, t))
    for q0 in range(0, t, tile):
        rows = slice(q0, min(q0 + tile, t))
        n_kt = min(n_tiles, (q0 + q_off + tile - 1) // tile + 1)
        m = torch.full((b, h, rows.stop - q0), tf.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, rows.stop - q0, d))
        for kt in range(n_kt):
            cols = slice(kt * tile, (kt + 1) * tile)
            sc = torch.einsum("bthd,bshd->bhts", q[:, rows], kp[:, cols])
            sc = torch.where(keep[:, :, rows, cols], sc * scale,
                             torch.full((), tf.NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + sum(
                torch.einsum("bhts,bshd->bhtd", x, vp[:, cols])
                for x in _round(p, split))
            m = m_new
        lm = l.clamp(min=1e-30)
        out[:, rows] = (acc / lm[..., None]).permute(0, 2, 1, 3)
        lse[:, :, rows] = m + torch.log(lm)
    return out, lse


def dq_model(q, k, v, mask, dout, lse, delta, split=True):
    """K5's arithmetic on bf16-valued f32 inputs -> dQ [B, T, H, D] in f32,
    before the output's bf16 rounding: P = keep ? exp(S * scale - lse) : 0,
    dS = P * (dO V^T - delta), dQ = (dS K) * scale with dS split hi + lo
    (or rounded once)."""
    scale = q.shape[-1] ** -0.5
    keep = tf._keep(mask, q.shape[1], k.shape[1])              # [B,1,T,S]
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = torch.einsum("bthd,bshd->bhts", dout, v)
    ds = p * (dp - delta[..., None])
    return sum(torch.einsum("bhts,bshd->bthd", x, k)
               for x in _round(ds, split)) * scale


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return float((a.float() - b.float()).norm() / b.float().norm())


def _inputs(seed, b, t, s, h):
    rng = np.random.default_rng(seed)
    q, k, v, g = (_bf16(rng.normal(size=(b, n, h, 128)))
                  for n in (t, s, s, t))
    mask = np.ones((b, s), np.int32)
    mask[0, s - 9:] = 0                          # padded tail
    mask[-1, :5] = 0                             # queries keep no key
    return q, k, v, g, mask


@pytest.mark.parametrize("t,s", [(40, 40), (24, 40), (37, 37)])
def test_split_model_matches_pallas_backward(t, s):
    """The model against _flash_backward's dK / dV pass in interpret mode
    (16-row blocks, several of them, a ragged tail, T < S), both from the
    Pallas forward's out and lse."""
    b, h = 2, 2
    q, k, v, g, mask = _inputs(t + s, b, t, s, h)
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    out, lse = jf._flash_forward(jq, jk, jv, jnp.asarray(mask), BLOCK, BLOCK)
    _, want_dk, want_dv = jf._flash_backward(jq, jk, jv, jnp.asarray(mask),
                                             out, lse, jg, BLOCK, BLOCK)
    lse_t = torch.from_numpy(np.asarray(lse)[:, 0, :t].reshape(b, h, t)
                             .copy())
    out_t = torch.from_numpy(np.array(out))
    delta = (g * out_t).sum(-1).transpose(1, 2).contiguous()
    dk, dv = dkv_model(q, k, v, torch.from_numpy(mask), g, lse_t, delta)
    assert _rel(dk, want_dk) < 1e-3 and _rel(dv, want_dv) < 1e-3
    assert np.isfinite(dk.numpy()).all() and np.isfinite(dv.numpy()).all()


@pytest.mark.parametrize("t", [1087, 1000])
def test_split_model_at_the_training_length(t):
    """One head at the stage-3 spliced length (T = S = 1087, and T < S):
    the split model stays two orders of magnitude under the card's 1e-3
    of flash_dkv_plain (~2.5e-6), where one bf16 rounding of P and dS
    fails it (~1.6e-3)."""
    s = 1087
    q, k, v, g, mask = _inputs(t, 2, t, s, 1)
    m = torch.from_numpy(mask)
    out, lse = tf.flash_forward_plain(q, k, v, m)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    want = tf.flash_dkv_plain(q, k, v, m, g, lse, delta)
    want = [x.float() for x in want]
    split = dkv_model(q, k, v, m, g, lse, delta)
    single = dkv_model(q, k, v, m, g, lse, delta, split=False)
    errs = [_rel(a, w) for a, w in zip(split, want)]
    single_errs = [_rel(a, w) for a, w in zip(single, want)]
    assert max(errs) < 1e-5
    assert min(single_errs) > 1e-3


def _pallas_forward(q, k, v, mask):
    """_flash_forward in interpret mode with 16-row blocks -> (out, lse
    [B, H, T]) as torch f32."""
    b, t, h, _ = q.shape
    out, lse = jf._flash_forward(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                 jnp.asarray(mask), BLOCK, BLOCK)
    lse_t = torch.from_numpy(np.asarray(lse)[:, 0, :t].reshape(b, h, t)
                             .copy())
    return out, lse_t


@pytest.mark.parametrize("t,s", [(40, 40), (24, 40), (37, 37)])
def test_fwd_model_matches_pallas_forward(t, s):
    """K4's model against _flash_forward in interpret mode (16-row blocks,
    ragged T, T < S, a padded tail, queries that keep no key): out and lse
    of the rows that keep a key; the no-key rows of the model finite."""
    b, h = 2, 2
    q, k, v, _, mask = _inputs(t + s, b, t, s, h)
    want_out, want_lse = _pallas_forward(q, k, v, mask)
    m = torch.from_numpy(mask)
    out, lse = fwd_model(q, k, v, m)
    live = tf._keep(m, t, s).any(-1)[:, 0]
    lv = live[..., None].expand(-1, -1, h)
    assert _rel(out[lv], np.array(want_out)[lv.numpy()]) < 1e-3
    assert float((lse.transpose(1, 2)[lv]
                  - want_lse.transpose(1, 2)[lv]).abs().max()) < 1e-4
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()
    assert (t != s) or int((~live).sum()) == 5


@pytest.mark.parametrize("t,s", [(40, 40), (24, 40), (37, 37)])
def test_dq_model_matches_pallas_backward(t, s):
    """K5's model against _flash_backward's dQ pass in interpret mode, from
    the Pallas forward's out and lse (rows that keep no key get zero)."""
    b, h = 2, 2
    q, k, v, g, mask = _inputs(t + s, b, t, s, h)
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    out, lse = jf._flash_forward(jq, jk, jv, jnp.asarray(mask), BLOCK, BLOCK)
    want_dq, _, _ = jf._flash_backward(jq, jk, jv, jnp.asarray(mask), out,
                                       lse, jg, BLOCK, BLOCK)
    lse_t = torch.from_numpy(np.asarray(lse)[:, 0, :t].reshape(b, h, t)
                             .copy())
    delta = (g * torch.from_numpy(np.array(out))).sum(-1).transpose(1, 2)
    dq = dq_model(q, k, v, torch.from_numpy(mask), g, lse_t,
                  delta.contiguous())
    assert _rel(dq, want_dq) < 1e-3
    assert np.isfinite(dq.numpy()).all()


@pytest.mark.parametrize("t", [1087, 1000])
def test_fwd_model_at_the_training_length(t):
    """K4's model at T = S = 1087 and T < S, against flash_forward_plain:
    with P split, out is ~2e-6 from plain (rel Frobenius over the rows
    that keep a key) and lse within 1e-5; one bf16 rounding of P would
    fail the card's 1e-3 (~1.2e-3 and ~1.4e-3). The no-key rows stay
    finite."""
    s = 1087
    q, k, v, _, mask = _inputs(t, 2, t, s, 1)
    m = torch.from_numpy(mask)
    want_out, want_lse = tf.flash_forward_plain(q, k, v, m)
    live = tf._keep(m, t, s).any(-1)[:, 0]
    lv = live[..., None].expand(-1, -1, 1)
    out, lse = fwd_model(q, k, v, m)
    single, _ = fwd_model(q, k, v, m, split=False)
    assert _rel(out[lv], want_out[lv]) < 1e-5
    assert float((lse.transpose(1, 2)[lv]
                  - want_lse.transpose(1, 2)[lv]).abs().max()) < 1e-5
    assert _rel(single[lv], want_out[lv]) > 1e-3
    assert np.isfinite(out.numpy()).all() and np.isfinite(lse.numpy()).all()


@pytest.mark.parametrize("t", [1087, 1000])
def test_dq_model_at_the_training_length(t):
    """K5's model at T = S = 1087 and T < S, against flash_dq_plain: with
    dS split, ~2.6e-6; one bf16 rounding of dS fails 1e-3 (~1.7e-3)."""
    s = 1087
    q, k, v, g, mask = _inputs(t, 2, t, s, 1)
    m = torch.from_numpy(mask)
    out, lse = tf.flash_forward_plain(q, k, v, m)
    delta = (g * out).sum(-1).transpose(1, 2).contiguous()
    want = tf.flash_dq_plain(q, k, v, m, g, lse, delta)
    assert _rel(dq_model(q, k, v, m, g, lse, delta), want) < 1e-5
    assert _rel(dq_model(q, k, v, m, g, lse, delta, split=False), want) > 1e-3
