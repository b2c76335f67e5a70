"""The opt-in modules of the port against the JAX package: the ragged MoE
dispatch, the device preprocess and the native preprocessing library (the
serving worker with device_preprocess=True: tests/test_torch_serve.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
from medplib_tpu.data import preprocess as jpp
from medplib_tpu.ops import device_preprocess as jdev
from medplib_tpu.ops import moe as jmoe
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch import native
from medplib_tpu_torch.data import preprocess as tpp
from medplib_tpu_torch.ops import device_preprocess as tdev
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.utils import convert
from test_torch_slice import port_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("bits", [None, 4])
def test_ragged_dispatch_matches_jax(bits):
    """moe_mlp(dispatch_mode="ragged") against JAX's (float experts 1e-5;
    int4h experts, dequantized per layer: 1e-4), and equal to the capacity
    dispatch when capacity >= S."""
    rng = np.random.default_rng(2)
    e, h, m = 4, 128, 256
    p = {"router": {"kernel": rng.normal(size=(h, e)).astype(np.float32)},
         "experts": {
             "gate_proj": {"kernel": rng.normal(
                 size=(e, h, m)).astype(np.float32) * h ** -0.5},
             "up_proj": {"kernel": rng.normal(
                 size=(e, h, m)).astype(np.float32) * h ** -0.5},
             "down_proj": {"kernel": rng.normal(
                 size=(e, m, h)).astype(np.float32) * m ** -0.5}}}
    if bits:
        p["experts"] = jax.tree_util.tree_map(np.asarray, jq.quantize_tree(
            jax.tree_util.tree_map(jnp.asarray, p["experts"]), skip=(),
            bits=4, int4_groups=2))
    x = rng.normal(size=(2, 37, h)).astype(np.float32)
    mcfg = jc.MoeConfig(enable=True, num_experts=e, top_k=1,
                        eval_capacity_factor=float(e))
    jpar = jax.tree_util.tree_map(jnp.asarray, p)
    want, aux_j = jax.jit(lambda q, v: jmoe.moe_mlp(
        q, v, mcfg, train=False, dispatch_mode="ragged"))(jpar, jnp.asarray(x))
    tpar = convert.tree_from_numpy(p, "cpu")
    got, aux_t = tmoe.moe_mlp(tpar, torch.from_numpy(x), port_cfg(mcfg),
                              train=False, dispatch_mode="ragged")
    tol = 1e-5 if bits is None else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    srt, _ = tmoe.moe_mlp(tpar, torch.from_numpy(x), port_cfg(mcfg),
                          train=False, dispatch_mode="sort")
    np.testing.assert_allclose(got.numpy(), srt.numpy(), rtol=tol, atol=tol)


SIZES = [(300, 500), (640, 480), (256, 256), (123, 77), (40, 513)]


@pytest.mark.parametrize("hw", SIZES)
def test_device_preprocess_matches_jax_and_host(hw):
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    sam_t, clip_t, rhw = tdev.dual_preprocess(img, device="cpu")
    sam_j, clip_j, rhw_j = jdev.dual_preprocess(img)
    assert rhw == tuple(rhw_j)
    np.testing.assert_allclose(sam_t.numpy(), np.asarray(sam_j), atol=2e-4)
    np.testing.assert_allclose(clip_t.numpy(), np.asarray(clip_j), atol=2e-4)
    sam_h, rhw_h = tpp.preprocess_sam(img)
    clip_h = tpp.preprocess_clip(img)
    assert rhw == tuple(rhw_h)
    d_sam = np.abs(sam_t.numpy() - sam_h) * tpp.SAM_PIXEL_STD
    d_clip = np.abs(clip_t.numpy() - clip_h) * tpp.CLIP_STD * 255.0
    assert d_sam.max() <= 2.0 and d_clip.max() <= 2.0
    assert tdev.pick_bucket(*hw) == jdev.pick_bucket(*hw)


@pytest.mark.parametrize("hw", SIZES)
def test_native_matches_jax_and_numpy(hw, monkeypatch):
    """The port's build of its copy of preprocess.cpp against the JAX
    package's library (equal) and the port's numpy resampler (1/255)."""
    assert native.available()
    assert native.library_path().parent.name == "medplib_tpu_torch"
    rng = np.random.default_rng(hw[1])
    img = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    sam_n, rhw_n = tpp.preprocess_sam(img)
    clip_n = tpp.preprocess_clip(img)
    assert tpp._native() is native
    sam_j, rhw_j = jpp.preprocess_sam(img)
    np.testing.assert_allclose(sam_n, sam_j, atol=1e-5)
    np.testing.assert_allclose(clip_n, jpp.preprocess_clip(img), atol=1e-5)
    assert tuple(rhw_n) == tuple(rhw_j)
    monkeypatch.setattr(tpp, "USE_NATIVE", False)
    sam_p, rhw_p = tpp.preprocess_sam(img)
    clip_p = tpp.preprocess_clip(img)
    assert tuple(rhw_p) == tuple(rhw_n)
    assert (np.abs(sam_p - sam_n) * tpp.SAM_PIXEL_STD).max() <= 1.0
    assert (np.abs(clip_p - clip_n) * tpp.CLIP_STD * 255).max() <= 1.0
    m = (rng.uniform(size=hw) > 0.7).astype(np.uint8)
    np.testing.assert_array_equal(native.encode_sparse_mask(m),
                                  np.argwhere(m > 0).astype(np.int32))
