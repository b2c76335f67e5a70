"""Matmuls against int4 "interleaved pairs" weights in medplib_tpu_torch,
against the JAX package on the CPU:

- kernel K9 (`ops/cuda/int4_matmul.int4h_matmul(_t)`, the packed
  pack_inference kernels) against the Pallas `int4h_matmul_pallas` /
  `int4h_matmul_t_pallas` in interpret mode. Tolerance: both sides sum the
  same f32 products (nibble * group scale, rounded in f32, times x) in
  another order, so they differ by at most the two f32 summation errors
  plus one rounding of the output dtype.
- the grouped XLA composition (`utils/quantize.int4h_matmul(_t)`, the
  other 2D int4h linears) against the JAX functions under jax.jit, which
  round every group's products and sums to x's dtype: bit-equal on bf16
  inputs; f32 sums in another order (rel 1e-6) on f32 inputs. A dequantize
  -then-matmul (one rounding) does not pass the bf16 check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.ops.pallas import int4_matmul as jk
from medplib_tpu.train import lora as jl
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.ops.cuda import int4_matmul as tk
from medplib_tpu_torch.train import lora as tl
from medplib_tpu_torch.utils import quantize as tq

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _weights(rng, k, n, groups, transposed):
    """A float weight quantized by the JAX quantizer -> (packed, scale4h)
    as numpy."""
    w = (rng.normal(size=(n, k) if transposed else (k, n)) * k ** -0.5
         ).astype(np.float32)
    q, s = jq._quantize_kernel4h(jnp.asarray(w), transposed, groups)
    return np.asarray(q), np.asarray(s)


def _x(rng, shape, bf16):
    x = rng.normal(size=shape).astype(np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt


# K = 1376 (688 packed rows, 86 per group at G = 8): no multiple of the
# 128-row blocks; N = 320 pads to the small tiling's 128-column blocks
@pytest.mark.parametrize("groups", [8, 2])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_int4h_kernel_matches_pallas(transposed, bf16, groups):
    rng = np.random.default_rng(groups + 2 * int(transposed))
    k, n = 1376, 320
    q, s = _weights(rng, k, n, groups, transposed)
    xj, xt = _x(rng, (2, 20, k), bf16)
    if bf16:
        want = jk._matmul(xj.reshape(40, k), jnp.asarray(q), jnp.asarray(s),
                          transposed, block_m=16, block_n=128).reshape(
                              2, 20, n)
    else:
        fn = jk.int4h_matmul_t_pallas if transposed else \
            jk.int4h_matmul_pallas
        want = fn(xj, jnp.asarray(q), jnp.asarray(s))
    n0 = tk.int4h_matmul_2d.launches
    fn = tk.int4h_matmul_t if transposed else tk.int4h_matmul
    got = fn(xt, _t(q), _t(s))
    assert tk.int4h_matmul_2d.launches == n0    # CPU: the plain version
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 20, n)
    w_deq = np.abs(tk.dequant_f32(_t(q), _t(s), transposed).double().numpy())
    sums = np.abs(_f32(xt)).astype(np.float64).reshape(40, k) @ w_deq
    g, wnt = _f32(got), _f32(want)
    tol = 2 * k * 2.0 ** -24 * sums.reshape(wnt.shape) \
        + np.abs(wnt) * (2.0 ** -7 if bf16 else 2.0 ** -23)
    assert np.all(np.abs(g - wnt) <= tol)


def test_int4h_dequant_f32_matches_reference_dequant():
    """The kernel's f32 weight equals the JAX package's dequant_int4h in
    f32, both layouts."""
    rng = np.random.default_rng(5)
    for transposed in (False, True):
        q, s = _weights(rng, 256, 64, 8, transposed)
        want = np.asarray(jq.dequant_int4h(jnp.asarray(q), jnp.asarray(s),
                                           jnp.float32))
        got = tk.dequant_f32(_t(q), _t(s), transposed).numpy()
        np.testing.assert_array_equal(got, want.T if transposed else want)


# (K, N, G, M): the serving G = 8, per-half G = 2, a K whose groups are no
# multiple of 64, a single row
@pytest.mark.parametrize("k,n,groups,m", [
    (512, 96, 8, 40), (256, 320, 2, 7), (1376, 80, 8, 33), (1024, 64, 8, 1),
])
@pytest.mark.parametrize("transposed", [False, True])
def test_int4h_matmul_bit_equal_to_compiled_reference(transposed, k, n,
                                                      groups, m):
    rng = np.random.default_rng(k + n + int(transposed))
    q, s = _weights(rng, k, n, groups, transposed)
    fj = jq.int4h_matmul_t if transposed else jq.int4h_matmul
    ft = tq.int4h_matmul_t if transposed else tq.int4h_matmul
    xj, xt = _x(rng, (2, m, k), True)
    want = jax.jit(fj)(xj, jnp.asarray(q), jnp.asarray(s))
    got = ft(xt, _t(q), _t(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    xj, xt = _x(rng, (2, m, k), False)
    want = _f32(jax.jit(fj)(xj, jnp.asarray(q), jnp.asarray(s)))
    got = _f32(ft(xt, _t(q), _t(s)))
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)


@pytest.mark.parametrize("transposed", [False, True])
def test_linear_routes_2d_int4h_nodes(transposed):
    """lora.linear / linear_t on a 2D int4h node with bias: the grouped
    products, bit-equal to the jitted JAX linear on bf16 inputs; a stacked
    [L, K/2, N] node still dequantizes (the JAX package's route too)."""
    rng = np.random.default_rng(11 + int(transposed))
    k, n = 256, 128
    q, s = _weights(rng, k, n, 8, transposed)
    bias = rng.normal(size=(n,)).astype(np.float32)
    xj, xt = _x(rng, (3, 5, k), True)
    jnode = {"kernel": jnp.asarray(q), "scale4h": jnp.asarray(s),
             "bias": jnp.asarray(bias).astype(jnp.bfloat16)}
    tnode = {"kernel": _t(q), "scale4h": _t(s),
             "bias": _t(bias).to(torch.bfloat16)}
    jf = jl.linear_t if transposed else jl.linear
    tf = tl.linear_t if transposed else tl.linear
    want = jax.jit(jf)(jnode, xj)
    np.testing.assert_array_equal(_f32(tf(tnode, xt)), _f32(want))
    if not transposed:
        stacked = {"kernel": tnode["kernel"][None],
                   "scale4h": tnode["scale4h"][None]}
        w = tl.dequant_kernel(stacked, torch.bfloat16)
        assert torch.equal(tl.linear(stacked, xt[None]), xt[None] @ w)
