"""The arithmetic of K6's bf16 tensor-core kernel (flash_dkv_mma_kernel in
medplib_tpu_torch/csrc/flash_attention.cu), modelled on the CPU.

The kernel runs every product as bf16 mma.sync with f32 sums: q, k, v and
dO are bf16 values, exact as operands; the scores S^T = K Q^T and
dP^T = V dO^T are f32 sums of exact products; the scale multiplies the f32
score sum. P and dS are not bf16 values, so each is split, hi = bf16(x),
lo = bf16(x - hi), and both halves are multiplied (f32 sums) into
dV = P^T dO and dK = dS^T Q * scale. The model below does the same in
float32 torch on the CPU. It is held to the JAX package's Pallas backward
(`_flash_backward`, interpret mode, small blocks, as
tests/test_torch_flash.py runs it) and, at the training sequence length,
to the port's plain version: rel Frobenius 1e-3, the tolerance the kernel
is held to on the card. A single bf16 rounding of P and dS, the trap the
split avoids, is shown to fail that tolerance at that length.
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
