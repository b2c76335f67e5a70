"""Kernels K7 (`int8_matmul`, weight-only int8) and K8 (`w8a8_matmul`,
dynamic W8A8) of medplib_tpu_torch against the Pallas kernels of
medplib_tpu/ops/pallas/int8_matmul.py on the CPU. There the port's
wrappers run their plain PyTorch versions and the Pallas kernels run in
interpret mode, as the JAX package's own tests run them. Inputs are made
with numpy from a seed and handed to both.

Tolerances. K7: both sides sum the same exact products in f32 in another
order, so they differ by at most the two f32 summation errors,
K * 2^-24 * sum_k |x w s| each, plus one rounding of the output dtype
(2^-7 relative for bf16, 2^-23 for f32). K8: the s32 sums are exact on
both sides and the epilogue is the same rounded f32 ops, so bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.ops.pallas import int8_matmul as jk
from medplib_tpu_torch.ops.cuda import int8_matmul as tk

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def sum_order_close(got, want, x, w_deq, out_bf16):
    """|got - want| <= both f32 summation error bounds + one output ulp."""
    got, want = _f32(got), _f32(want)
    x, w_deq = np.abs(_f32(x)).astype(np.float64), np.abs(w_deq)
    k = x.shape[-1]
    sums = x.reshape(-1, k) @ w_deq
    tol = 2 * k * 2.0 ** -24 * sums.reshape(want.shape) \
        + np.abs(want) * (2.0 ** -7 if out_bf16 else 2.0 ** -23)
    return bool(np.all(np.abs(got - want) <= tol))


def _operands(rng, lead, k, n, transposed, bf16):
    x = rng.normal(size=lead + (k,)).astype(np.float32)
    w = rng.integers(-127, 128, size=(n, k) if transposed else (k, n)
                     ).astype(np.int8)
    s = rng.uniform(1e-3, 2e-2, size=(n, 1) if transposed else (1, n)
                    ).astype(np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt, w, s


def _w_deq(w, s, transposed):
    wd = w.astype(np.float64) * s.astype(np.float64)
    return wd.T if transposed else wd


# K = 688 is no multiple of 128; N = 320 pads to the 128-column blocks
# of the small tiling, M = 40 to its 16-row blocks
@pytest.mark.parametrize("small_blocks", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_int8_matmul_matches_pallas(transposed, bf16, small_blocks):
    rng = np.random.default_rng(int(transposed) + 2 * int(bf16))
    k, n = 688, 320
    xj, xt, w, s = _operands(rng, (2, 20), k, n, transposed, bf16)
    if small_blocks:
        want = jk._matmul(xj.reshape(40, k), jnp.asarray(w), jnp.asarray(s),
                          transposed, block_m=16, block_n=128).reshape(
                              2, 20, n)
    else:
        fn = jk.int8_matmul_t if transposed else jk.int8_matmul
        want = fn(xj, jnp.asarray(w), jnp.asarray(s))
    n0 = tk.int8_matmul_2d.launches
    fn = tk.int8_matmul_t if transposed else tk.int8_matmul
    got = fn(xt, _t(w), _t(s))
    assert tk.int8_matmul_2d.launches == n0     # CPU: the plain version
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 20, n)
    assert sum_order_close(got, want, xt, _w_deq(w, s, transposed), bf16)


def _w8a8_operands(rng, m, k, n, transposed, bf16):
    """|x| and |w| near 127 after quantization, with one sign per row of x
    and per column of w, so the s32 sums pass 2^24 at K = 2048."""
    x = (rng.uniform(100, 127, size=(m, k))
         * rng.choice([-1, 1], size=(m, 1))
         * rng.uniform(0.01, 3.0, size=(m, 1))).astype(np.float32)
    w = (rng.integers(100, 128, size=(k, n))
         * rng.choice([-1, 1], size=(1, n))).astype(np.int8)
    s = rng.uniform(1e-3, 2e-2, size=(1, n)).astype(np.float32)
    if transposed:
        w, s = np.ascontiguousarray(w.T), np.ascontiguousarray(s.T)
    xj, xt = jnp.asarray(x), _t(x)
    if bf16:
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    return xj, xt, w, s


@pytest.mark.parametrize("k,bf16,transposed", [
    (2048, True, False), (2048, True, True), (2048, False, False),
    (688, True, True),
])
def test_w8a8_matmul_bit_equal_to_pallas(k, bf16, transposed):
    """K8 against the jitted Pallas call (the compiled reference computes
    the activation scale as absmax * f32(1/127), as quantize_rows does):
    bit-equal, with s32 sums above 2^24 at K = 2048 where an f32
    accumulation would round."""
    rng = np.random.default_rng(k + int(transposed))
    m, n = 96, 192
    xj, xt, w, s = _w8a8_operands(rng, m, k, n, transposed, bf16)
    fn = jk.w8a8_matmul_t if transposed else jk.w8a8_matmul
    want = jax.jit(fn)(xj, jnp.asarray(w), jnp.asarray(s))
    x_q, _ = tk.quantize_rows(xt)
    big = np.abs(x_q.double().numpy() @ (w.T if transposed else w)
                 .astype(np.float64)).max()
    assert k < 2048 or big > 2 ** 24
    n0 = tk.w8a8_matmul_2d.launches
    fn = tk.w8a8_matmul_t if transposed else tk.w8a8_matmul
    got = fn(xt, _t(w), _t(s))
    assert tk.w8a8_matmul_2d.launches == n0
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_wrappers_reject_bad_operands():
    x = torch.zeros((4, 32))
    w = torch.zeros((32, 48), dtype=torch.int8)
    with pytest.raises(ValueError):       # transposed needs [N, K] + [N, 1]
        tk.int8_matmul_t(x, w, torch.ones((1, 48)))
    with pytest.raises(ValueError):       # scale must match the layout
        tk.int8_matmul(x, w, torch.ones((48, 1)))
    with pytest.raises(ValueError):       # K mismatch
        tk.w8a8_matmul(torch.zeros((4, 16)), w, torch.ones((1, 48)))
    with pytest.raises(ValueError):       # the weight must be int8
        tk.int8_matmul(x, w.float(), torch.ones((1, 48)))
