"""Repairs of the port against the JAX package, on the CPU:

- ops/cuda/pad.pad_operands, the zero padding the CUDA wrappers of K1, K3,
  K7, K8 and K9 (f32 x) apply to odd widths: each kernel's plain version
  on the padded operands, sliced back to N columns, equals it on the
  unpadded ones (integer sums: bit-equal; float sums: the same products
  plus exact zeros, summed in f32 in another blocking: rel 1e-6), and
  operands that need no padding come back as they are (no copy);
- the `train` defaults of the MoE entry points equal the JAX signatures.
"""

import inspect

import numpy as np
import pytest
import torch

from medplib_tpu.models import moe_llama as jml
from medplib_tpu.ops import moe as jmoe
from medplib_tpu_torch.models import moe_llama as tml
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.ops.cuda import gmm as G
from medplib_tpu_torch.ops.cuda import int4_matmul as I4
from medplib_tpu_torch.ops.cuda import int8_matmul as I8
from medplib_tpu_torch.ops.cuda.pad import pad_operands

torch.set_num_threads(1)

K, N = 688, 320          # the odd widths of the CPU kernel tests


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, exact):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        assert torch.equal(got, want)
    else:
        g, w = got.double(), want.double()
        assert float((g - w).norm() / w.norm()) <= 1e-6


def _int8_operands(rng, m, k, n, transposed):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, size=(n, k) if transposed
                                      else (k, n)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(n, 1) if transposed
                                     else (1, n)).astype(np.float32))
    return x, w, s


@pytest.mark.parametrize("transposed", [False, True])
def test_pad_keeps_int8_matmul_and_w8a8(transposed):
    """K7 / K8 pad K and N to multiples of 16."""
    x, w, s = _int8_operands(_rng(1 + transposed), 37, K, N - 3, transposed)
    kn = (1, 0) if transposed else (0, 1)
    xp, wp, sp = pad_operands(x, w, s, 16, 16, *kn, scale_n_dim=kn[1])
    assert xp.shape[1] % 16 == 0 and wp.shape[kn[1]] % 16 == 0
    n = N - 3
    got = I8.int8_matmul_plain(xp, wp, sp, transposed)[:, :n]
    _close(got, I8.int8_matmul_plain(x, w, s, transposed), False)
    xq, a_s = I8.quantize_rows(x)
    xqp, wp, sp = pad_operands(xq, w, s, 16, 16, *kn, scale_n_dim=kn[1])
    got = I8.w8a8_matmul_plain(xqp, a_s, wp, sp, transposed,
                               torch.float32)[:, :n]
    _close(got, I8.w8a8_matmul_plain(xq, a_s, w, s, transposed,
                                     torch.float32), True)


@pytest.mark.parametrize("mode", ["W8A8", "int8-w", "float"])
@pytest.mark.parametrize("transposed", [False, True])
def test_pad_keeps_gmm(mode, transposed):
    """K3 pads K and N of the expert stack to multiples of 16."""
    rng = _rng(3)
    e, s, bm, n = 2, 90, 32, N - 5
    xs = torch.from_numpy(rng.normal(size=(s, K)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, size=(s,)))
    x_al, _, gid = G.align_groups(xs, idx, e, bm)
    wshape = (e, n, K) if transposed else (e, K, n)
    ws = a_s = None
    if mode == "float":
        w = torch.from_numpy(rng.normal(size=wshape).astype(np.float32))
    else:
        w = torch.from_numpy(rng.integers(-127, 128, size=wshape)
                             .astype(np.int8))
        ws = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(e, 1, n))
                              .astype(np.float32))
    if mode == "W8A8":
        x_al, a_s = G.quantize_rows(x_al)
    kn = (2, 1) if transposed else (1, 2)
    xp, wp, wsp = pad_operands(x_al, w, ws, 16, 16, *kn)
    got = G.gmm_plain(xp, wp, gid, wsp, a_s, bm, torch.float32,
                      transposed)[:, :n]
    want = G.gmm_plain(x_al, w, gid, ws, a_s, bm, torch.float32, transposed)
    _close(got, want, mode == "W8A8")


@pytest.mark.parametrize("a8", [True, False])
def test_pad_keeps_gmm_int4h(a8):
    """K1 pads N to the multiple its kernel takes: 16 in A8 (the s8
    tensor-core kernel guards N at 16), 64 on bf16 x (the float kernel's
    unguarded 64-column tile)."""
    rng = _rng(4)
    e, s, bm, k, n = 2, 70, 32, 512, 200
    xs = torch.from_numpy(rng.normal(size=(s, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, size=(s,)))
    x_al, _, gid = G.align_groups(xs, idx, e, bm)
    packed = torch.from_numpy(rng.integers(-128, 128, size=(e, k // 2, n))
                              .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(e, 2, 1, n))
                             .astype(np.float32))
    a_s = None
    if a8:
        x_al, a_s = G.quantize_rows(x_al)
    xp, pp, sp = pad_operands(x_al, packed, scale, 1, 16 if a8 else 64, 1,
                              2)
    assert pp.shape[2] == (208 if a8 else 256) and xp is x_al
    got = G.gmm_int4h_plain(xp, pp, sp, gid, a_s, bm)[:, :n]
    want = G.gmm_int4h_plain(x_al, packed, scale, gid, a_s, bm)
    _close(got.float(), want.float(), a8)


@pytest.mark.parametrize("transposed", [False, True])
def test_pad_keeps_int4h_matmul_n(transposed):
    """K9 pads N (f32 x: to a multiple of 16; its K padding keeps the
    unpadded group map, which the kernel takes as gsize)."""
    rng = _rng(5 + transposed)
    m, n, g = 21, N - 6, 8
    x = torch.from_numpy(rng.normal(size=(m, K)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(
        -128, 128, size=(n, K // 2) if transposed else (K // 2, n))
        .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(
        g, n, 1) if transposed else (g, 1, n)).astype(np.float32))
    kn = (1, 0) if transposed else (0, 1)
    xp, pp, sp = pad_operands(x, packed, scale, 2, 16, *kn,
                              scale_n_dim=1 if transposed else 2,
                              k_per_w_row=2)
    assert xp is x and pp.shape[kn[1]] == N
    got = I4.int4h_matmul_plain(xp, pp, sp, transposed)[:, :n]
    _close(got, I4.int4h_matmul_plain(x, packed, scale, transposed), False)


def test_pad_returns_aligned_operands_as_they_are():
    x, w, s = _int8_operands(_rng(6), 8, 64, 32, False)
    xp, wp, sp = pad_operands(x, w, s, 16, 16, 0, 1, scale_n_dim=1)
    assert xp is x and wp is w and sp is s


@pytest.mark.parametrize("pair", [
    (tmoe.moe_mlp, jmoe.moe_mlp),
    (tml.make_moe_mlp_apply, jml.make_moe_mlp_apply),
    (tml.forward, jml.forward),
], ids=["moe_mlp", "make_moe_mlp_apply", "moe_llama.forward"])
def test_train_defaults_equal_jax(pair):
    port, ref = (inspect.signature(f).parameters["train"].default
                 for f in pair)
    assert port is ref is True
