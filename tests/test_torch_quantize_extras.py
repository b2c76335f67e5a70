"""The port's quantization extras against the JAX package's, on the CPU:
the int4 "block" scheme (utils/quantize._quantize_kernel4 and
quantize_tree(int4_scheme="block"), bit-equal), its dequant in
train/lora.dequant_kernel and the linears over it, dequantize_matmul,
dequantize_tree on a tree mixing the three quantized layouts,
pad_dense_mlp_for_gmm before and after int8 quantization, and
quantize_tree's errors.

Inputs come from numpy seeds; JAX trees are snapshotted to numpy before
the JAX quantizers (which donate their input) run. Quantized bytes,
scales and dequantized kernels must be EQUAL; products in float32 within
1e-5 (relative and absolute: the same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import llama as jllama
from medplib_tpu.train import lora as jl
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.train import lora as tl
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import quantize as tq
from medplib_tpu_torch.utils import tree as tree_util

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def snap(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def assert_tree_equal(got, want_host):
    gl = tree_util.leaves_with_paths(got)
    wl = tree_util.leaves_with_paths(convert.tree_from_numpy(want_host,
                                                             "cpu"))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


# ---------------------------------------------------------------------------
# the int4 block quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape,block", [
    ((128, 96), 64),          # block divides in (normal) / not (transposed)
    ((96, 128), 64),
    ((3, 128, 96), 32),       # stacked leading dim
    ((2, 2, 64, 48), 16),
    ((130, 64), 64)])
def test_quantize_kernel4_bit_equal(transposed, shape, block):
    w = randn(np.random.default_rng(0), *shape)
    jq_, js = jq._quantize_kernel4(jnp.asarray(w.copy()), transposed, block)
    tq_, ts = tq._quantize_kernel4(torch.from_numpy(w), transposed, block)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
def test_dequant_and_linears_on_scale4(dtype, transposed):
    """dequant_kernel on a block-int4 node equals JAX's (bit for bit, in
    the target dtype); linear / linear_t over it match JAX's (float32:
    1e-5; bf16: the same bf16 product, 1e-2 relative to the output norm
    for the summation order)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(1)
    w = randn(rng, 128, 64) if not transposed else randn(rng, 64, 128)
    jk, js = jq._quantize_kernel4(jnp.asarray(w.copy()), transposed, 32)
    node_j = {"kernel": jk, "scale4": js}
    node_t = {"kernel": torch.from_numpy(np.array(jk)),
              "scale4": torch.from_numpy(np.array(js))}
    want = np.asarray(jl.dequant_kernel(node_j, jdt).astype(jnp.float32))
    got = tl.dequant_kernel(node_t, dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)

    x = randn(rng, 2, 5, 128)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(dtype)
    if transposed:
        yj = jax.jit(jl.linear_t)(node_j, xj)
        yt = tl.linear_t(node_t, xt)
    else:
        yj = jax.jit(jl.linear)(node_j, xj)
        yt = tl.linear(node_t, xt)
    yj = np.asarray(yj.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(yt.numpy(), yj, **TOL)
    else:
        rel = np.linalg.norm(yt.float().numpy() - yj) / np.linalg.norm(yj)
        assert rel < 1e-2, rel


def test_quantize_tree_block_scheme_leaf_for_leaf():
    host = snap(jllama.init_llama(jax.random.PRNGKey(0),
                                  jc.LlamaConfig.tiny(), jnp.float32))
    want = snap(jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, host),
                                 bits=4, int4_scheme="block", block=32))
    got = tq.quantize_tree(convert.tree_from_numpy(host, "cpu"), bits=4,
                           int4_scheme="block", block=32)
    assert "scale4" in got["layers"]["attn"]["q_proj"]
    assert "scale4h" not in got["layers"]["mlp"]["down_proj"]
    assert_tree_equal(got, want)


@pytest.mark.parametrize("kwargs,match", [
    (dict(bits=3), "bits must be 4 or 8"),
    (dict(bits=16), "bits must be 4 or 8"),
    (dict(bits=4, int4_scheme="nf4"), "unknown int4_scheme"),
    (dict(bits=8, int4_scheme="pairs"), "unknown int4_scheme")])
def test_quantize_tree_errors(kwargs, match):
    tree = {"x": {"kernel": torch.zeros(64, 64)}}
    with pytest.raises(ValueError, match=match):
        tq.quantize_tree(tree, **kwargs)
    with pytest.raises(ValueError, match=match):
        jq.quantize_tree({"x": {"kernel": jnp.zeros((64, 64))}}, **kwargs)


# ---------------------------------------------------------------------------
# dequantize_matmul, dequantize_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True])
def test_dequantize_matmul(transposed):
    rng = np.random.default_rng(2)
    w = randn(rng, 3, 48, 64)
    out_axis = 1 if transposed else 2
    jk, js = jq._quantize_kernel(jnp.asarray(w.copy()), out_axis)
    x = randn(rng, 3, 5, 64 if transposed else 48)
    for i in range(3):
        pj = {"kernel": jk[i], "scale": js[i]}
        pt = {"kernel": torch.from_numpy(np.array(jk[i])),
              "scale": torch.from_numpy(np.array(js[i]))}
        want = jax.jit(jq.dequantize_matmul, static_argnums=2)(
            jnp.asarray(x[i]), pj, transposed)
        got = tq.dequantize_matmul(torch.from_numpy(x[i]), pt, transposed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_tree_mixed_layouts(dtype):
    """attention int8 ("scale"), the MLP int4 block ("scale4"), the
    lm_head int4h ("scale4h"): every kernel back to `dtype`, scales gone,
    equal to JAX's."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    p = jllama.init_llama(jax.random.PRNGKey(3), jc.LlamaConfig.tiny(),
                          jnp.float32)
    p["layers"]["attn"] = jq.quantize_tree(p["layers"]["attn"], bits=8)
    p["layers"]["mlp"] = jq.quantize_tree(p["layers"]["mlp"], bits=4,
                                          int4_scheme="block", block=32)
    p["lm_head"] = jq.quantize_tree(p["lm_head"], skip=(), bits=4)
    host = snap(p)
    keys = {k for _, node in jl._iter_linear_paths(host) for k in node}
    assert {"scale", "scale4", "scale4h"} <= keys
    want = snap(jq.dequantize_tree(jax.tree_util.tree_map(jnp.asarray, host),
                                   jdt))
    got = tq.dequantize_tree(convert.tree_from_numpy(host, "cpu"), dtype)
    assert_tree_equal(got, want)
    assert not any(p[-1].startswith("scale")
                   for p, _ in tree_util.leaves_with_paths(got))


# ---------------------------------------------------------------------------
# pad_dense_mlp_for_gmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_pad_dense_mlp_for_gmm(quantized):
    """M 576 -> 1024 on the float tree and on the int8 tree (scales pad
    with gate / up's out axis): the padded stacks equal JAX's and the
    forward is unchanged (1e-5). int4 layouts must pad first."""
    cfg = jc.LlamaConfig(num_layers=2, hidden_size=128, intermediate_size=576,
                         num_heads=2, num_kv_heads=2, vocab_size=64,
                         max_position_embeddings=64)
    p = jllama.init_llama(jax.random.PRNGKey(4), cfg, jnp.float32)
    if quantized:
        p = jq.quantize_tree(p)
    host = snap(p)
    tcfg = tc.LlamaConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})
    tree = convert.tree_from_numpy(host, "cpu")
    x = torch.from_numpy(randn(np.random.default_rng(5), 2, 6, 128) * 0.1)
    y_ref = tllama.forward(tree, tcfg, x)[0]
    want = snap(jq.pad_dense_mlp_for_gmm(jax.tree_util.tree_map(
        jnp.asarray, host)["layers"]["mlp"]))
    got = tq.pad_dense_mlp_for_gmm(tree["layers"]["mlp"])
    assert tuple(got["gate_proj"]["kernel"].shape) == (2, 128, 1024)
    assert tuple(got["down_proj"]["kernel"].shape) == (2, 1024, 128)
    if quantized:
        assert got["gate_proj"]["scale"].shape[-1] == 1024
        assert got["down_proj"]["scale"].shape[-1] == 128
    assert_tree_equal(got, want)
    y_pad = tllama.forward(tree, tcfg, x)[0]
    np.testing.assert_allclose(y_pad.numpy(), y_ref.numpy(), **TOL)
    q4 = tq.quantize_tree(convert.tree_from_numpy(
        snap(jllama.init_llama(jax.random.PRNGKey(6), cfg, jnp.float32)),
        "cpu"), bits=4)
    with pytest.raises(AssertionError, match="int4"):
        tq.pad_dense_mlp_for_gmm(q4["layers"]["mlp"])
