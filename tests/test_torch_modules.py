"""Each ported module of medplib_tpu_torch against its JAX function, on the
CPU, with the same inputs (made with numpy from a seed) and the same
params (the JAX init bridged leaf for leaf through utils/convert). Float32
throughout; the JAX side runs at `highest` matmul precision (conftest).
Unless a test says otherwise the tolerance is 1e-5 (relative and
absolute): the same math in float32, summed in another order."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import clip as jclip
from medplib_tpu.models import llama as jllama
from medplib_tpu.models import projector as jproj
from medplib_tpu.models import sam_med2d as jsam
from medplib_tpu.ops import attention as jatt
from medplib_tpu.ops import moe as jmoe
from medplib_tpu.ops import norms as jnorms
from medplib_tpu.ops import rope as jrope
from medplib_tpu.ops import splice as jsplice
from medplib_tpu.train import lora as jlora
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.models import clip as tclip
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.models import projector as tproj
from medplib_tpu_torch.models import sam_med2d as tsam
from medplib_tpu_torch.ops import attention as tatt
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.ops import norms as tnorms
from medplib_tpu_torch.ops import rope as trope
from medplib_tpu_torch.ops import splice as tsplice
from medplib_tpu_torch.train import lora as tlora
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import quantize as tq

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def port_cfg(c):
    """A medplib_tpu config -> the port's class of the same name."""
    if dataclasses.is_dataclass(c):
        cls = getattr(tc, type(c).__name__)
        return cls(**{f.name: port_cfg(getattr(c, f.name))
                      for f in dataclasses.fields(c)})
    return c


def snap(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bridge(tree):
    return convert.tree_from_numpy(snap(tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


RNG = np.random.default_rng(0)


def randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# config, bridge, import guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["LlamaConfig", "MoeConfig",
                                  "ClipVisionConfig", "SamConfig",
                                  "ProjectorConfig", "SegConfig",
                                  "MedplibConfig", "TrainConfig"])
def test_config_matches_reference(name):
    """Same fields with the same defaults as the JAX package's classes."""
    j, t = getattr(jc, name)(), getattr(tc, name)()
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert port_cfg(j) == t


def test_flagship_cfg_matches_graft_entry():
    import __graft_entry__ as ge
    assert port_cfg(ge._flagship_cfg(32, moe=True)) == tc.flagship_cfg(32)
    assert tc.flagship_cfg(32).moe.layer_indices(32) == tuple(range(32))


def test_convert_keeps_paths_dtypes_and_bytes():
    tree = {"a": {"kernel": jnp.asarray(randn(3, 4)).astype(jnp.bfloat16),
                  "scale": jnp.asarray(randn(1, 4))},
            "l": [{"q": jnp.asarray(np.arange(6, dtype=np.int8))}]}
    t = bridge(tree)
    assert t["a"]["kernel"].dtype == torch.bfloat16
    assert t["l"][0]["q"].dtype == torch.int8
    back = convert.tree_to_numpy(t)
    np.testing.assert_array_equal(
        back["a"]["kernel"], np.asarray(tree["a"]["kernel"], np.float32))
    np.testing.assert_array_equal(back["l"][0]["q"], np.arange(6))


_BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
              "sys.modules['medplib_tpu'] = None; ")


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package, imports on
    a machine without JAX and without the JAX package; so does
    chip_smoke.py (as a module: its main does not run)."""
    code = _BLOCK_JAX + (
        "import pkgutil, importlib, medplib_tpu_torch as pkg; "
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]; "
        "[importlib.import_module(n) for n in names]; "
        "import chip_smoke; print(len(names))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    import medplib_tpu_torch
    import pkgutil
    want = {m.name for m in pkgutil.walk_packages(
        medplib_tpu_torch.__path__, "medplib_tpu_torch.")}
    assert int(out.stdout.strip()) == len(want), (out.stdout, want)
    assert {"medplib_tpu_torch.utils.export",
            "medplib_tpu_torch.models.geo_sampler",
            "medplib_tpu_torch.ops.sampling"} <= want


@pytest.mark.parametrize("kw", [
    dict(), dict(token_compress=True), dict(mask_encoder=True),
    dict(token_compress=True, compress_tokens=100, mask_encoder=True,
         mask_encoder_tokens=32, max_icl_examples=5)])
@pytest.mark.parametrize("tiny", [False, True])
def test_with_icl_matches_reference(kw, tiny):
    j = jc.MedplibConfig.tiny() if tiny else jc.MedplibConfig()
    assert port_cfg(jc.with_icl(j, **kw)) == tc.with_icl(port_cfg(j), **kw)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_norms():
    x, w, b = randn(4, 7, 64), randn(64), randn(64)
    close(tnorms.rms_norm(_t(x), _t(w), 1e-5),
          jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    close(tnorms.layer_norm(_t(x), _t(w), _t(b)),
          jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    close(tnorms.layer_norm_2d(_t(x), _t(w), _t(b)),
          jnorms.layer_norm_2d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)))


def test_rope():
    pos = RNG.integers(0, 600, size=(3, 9))
    cj, sj = jrope.rope_cos_sin(jnp.asarray(pos), 64)
    ct, st = trope.rope_cos_sin(_t(pos), 64)
    close(ct, cj)
    close(st, sj)
    x = randn(3, 9, 4, 64)
    close(trope.apply_rope(_t(x), ct, st),
          jrope.apply_rope(jnp.asarray(x), cj, sj))


def test_causal_and_decode_attention():
    q, k, v = randn(2, 6, 4, 16), randn(2, 6, 2, 16), randn(2, 6, 2, 16)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0                              # padded tail, GQA n_rep 2
    close(tatt.causal_attention(_t(q), _t(k), _t(v), _t(mask)),
          jatt.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask)))
    close(tatt.make_causal_bias(_t(mask), 3, 6),
          jatt.make_causal_bias(jnp.asarray(mask), 3, 6), rtol=0, atol=0)
    lens = np.array([3, 6], np.int32)
    close(tatt.decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(lens)),
          jatt.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens)))


def _splice_inputs():
    b, t = 3, 10
    ids = RNG.integers(3, 400, size=(b, t))
    ids[:, 2] = jc.IMAGE_TOKEN_INDEX
    ids[1, 6] = jc.IMAGE_TOKEN_INDEX             # two images in row 1
    ids[2, 5] = jc.REGION_TOKEN_INDEX
    ids[:, 7] = 499                              # the SEG id below
    mask = np.ones((b, t), np.int32)
    mask[0, 8:] = 0
    lens = np.full((b, 2), 4, np.int32)
    lens[0, 1] = lens[2, 1] = 0
    return ids, mask, lens


def test_splice():
    ids, mask, lens = _splice_inputs()
    starts = np.broadcast_to(np.arange(2)[None] * 4, lens.shape)
    smj = jsplice.compute_splice_map(jnp.asarray(ids), jnp.asarray(mask),
                                     jnp.asarray(lens), 16, jnp.asarray(starts))
    smt = tsplice.compute_splice_map(_t(ids), _t(mask), _t(lens), 16,
                                     _t(starts))
    for f in smj._fields:
        np.testing.assert_array_equal(getattr(smt, f).numpy(),
                                      np.asarray(getattr(smj, f)), err_msg=f)
    emb, feats, reg = randn(3, 10, 8), randn(3, 8, 8), randn(3, 1, 8)
    labels = ids.copy()
    oj = jsplice.splice_embeddings(smj, jnp.asarray(ids), jnp.asarray(emb),
                                   jnp.asarray(feats), jnp.asarray(reg),
                                   jnp.asarray(labels), seg_token_idx=499)
    ot = tsplice.splice_embeddings(smt, _t(ids), _t(emb), _t(feats), _t(reg),
                                   _t(labels), seg_token_idx=499)
    close(ot[0], oj[0], rtol=0, atol=0)
    np.testing.assert_array_equal(ot[1].numpy(), np.asarray(oj[1]))
    np.testing.assert_array_equal(ot[2].numpy(), np.asarray(oj[2]))
    hidden = randn(3, 16, 8)
    gj = jsplice.gather_seg_embeddings(jnp.asarray(hidden), oj[2], 2)
    gt = tsplice.gather_seg_embeddings(_t(hidden), ot[2], 2)
    close(gt[0], gj[0], rtol=0, atol=0)
    np.testing.assert_array_equal(gt[1].numpy(), np.asarray(gj[1]))
    np.testing.assert_array_equal(gt[2].numpy(), np.asarray(gj[2]))


# ---------------------------------------------------------------------------
# quantization and the linears
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True])
def test_quantize_kernel_int8_byte_identical(transposed):
    w = randn(2, 64, 96, scale=0.1)
    out_axis = 1 if transposed else 2
    qj, sj = jq._quantize_kernel(jnp.asarray(w), out_axis)
    qt, st = tq._quantize_kernel(_t(w), out_axis)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("transposed,groups", [(False, 2), (False, 8),
                                               (True, 2), (True, 8)])
def test_quantize_kernel4h_byte_identical(transposed, groups):
    """The pairs layout: packed bytes and scales equal the JAX ones."""
    w = randn(2, 64, 128, scale=0.1)
    pj, sj = jq._quantize_kernel4h(jnp.asarray(w), transposed, groups)
    pt, st = tq._quantize_kernel4h(_t(w), transposed, groups)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    close(tq.dequant_int4h(pt, st, torch.float32),
          jq.dequant_int4h(pj, sj, jnp.float32), rtol=0, atol=0)


def _tiny_moe_llm():
    llm = jc.LlamaConfig(vocab_size=128, hidden_size=256,
                         intermediate_size=200, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=64)
    mcfg = jc.MoeConfig(enable=True, num_experts=2, top_k=1)
    from medplib_tpu.models import moe_llama
    p = moe_llama.init_moe_llama(jax.random.PRNGKey(1), llm, mcfg,
                                 jnp.float32, 128)
    return llm, mcfg, p


def test_quantize_flagship_moe_tree_identical():
    """Pad (M 200 -> 1024) + int4h experts + int8 elsewhere, with the same
    skip list: every leaf of the two trees is equal."""
    _, _, p = _tiny_moe_llm()
    tree = {"llm": p, "sam": {"w": {"kernel": jnp.ones((64, 64))}}}
    float_tree = snap(tree)
    jt = snap(jq.quantize_flagship_moe(tree, 4, 8))
    tt = convert.tree_to_numpy(tq.quantize_flagship_moe(
        convert.tree_from_numpy(float_tree, device="cpu"), 4, 8))
    lj = jax.tree_util.tree_flatten_with_path(jt)[0]
    lt = dict(jax.tree_util.tree_flatten_with_path(tt)[0])
    assert len(lj) == len(lt)
    for path, leaf in lj:
        np.testing.assert_array_equal(lt[path], leaf, err_msg=str(path))
    assert "scale4h" in jt["llm"]["layers"]["moe"]["experts"]["down_proj"]
    assert "scale" not in jt["sam"]["w"]


def test_int4h_expert_einsum():
    w = randn(2, 64, 96, scale=0.1)
    p, s = jq._quantize_kernel4h(jnp.asarray(w), False, 2)
    x = randn(2, 5, 64)
    close(tq.int4h_expert_einsum(_t(x), _t(p), _t(s)),
          jq.int4h_expert_einsum(jnp.asarray(x), p, s))


@pytest.mark.parametrize("transposed", [False, True])
def test_int8_dyn_matmul(transposed):
    """Exact s32 products on both sides; the compiled reference scales by
    amax * f32(1/127) as the port does."""
    w = randn(96, 64) if transposed else randn(64, 96)
    qj, sj = jq._quantize_kernel(jnp.asarray(w), 0 if transposed else 1)
    x = randn(520, 64)
    want = jax.jit(lambda a: jq.int8_dyn_matmul(a, qj, sj, transposed))(
        jnp.asarray(x))
    got = tq.int8_dyn_matmul(_t(x), _t(qj), _t(sj), transposed)
    close(got, want)


@pytest.mark.parametrize("rows,actq", [(4, False), (520, False), (520, True)])
def test_linear_and_linear_t(rows, actq):
    """Float, int8 weight-only and (>= 512 rows under act-quant) W8A8."""
    x = randn(rows, 64)
    for name, shape in (("o_proj", (64, 96)), ("q_proj", (96, 64))):
        node = {"kernel": jnp.asarray(randn(*shape, scale=0.1)),
                "bias": jnp.asarray(randn(shape[0] if name == "q_proj"
                                          else shape[1]))}
        qnode = snap(jq.quantize_tree({name: dict(node)})[name])
        jf = jlora.linear_t if name == "q_proj" else jlora.linear
        tf = tlora.linear_t if name == "q_proj" else tlora.linear
        for n in (snap(node), qnode):
            with jq.dynamic_act_quant(actq):
                want = jax.jit(lambda a, nn: jf(nn, a))(jnp.asarray(x), n)
            with tq.dynamic_act_quant(actq):
                got = tf(convert.tree_from_numpy(n, device="cpu"), _t(x))
            close(got, want)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_clip_forward_features():
    cfg = jc.ClipVisionConfig.tiny()
    p = jax.jit(lambda k: jclip.init_clip_vision(k, cfg))(
        jax.random.PRNGKey(2))
    px = randn(2, 56, 56, 3)
    close(tclip.forward_features(bridge(p), _t(px), port_cfg(cfg)),
          jax.jit(lambda pp, x: jclip.forward_features(pp, x, cfg))(
              p, jnp.asarray(px)), rtol=1e-4,
          atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_projector(quant):
    """mlp2x_gelu (exact GELU); int8 nodes run W8A8 at >= 512 rows."""
    cfg = jc.ProjectorConfig(mm_hidden_size=64, hidden_size=96)
    p = jproj.init_projector(jax.random.PRNGKey(3), cfg)
    if quant:
        p = jq.quantize_tree(p)
    x = randn(2, 300, 64)
    with jq.dynamic_act_quant(quant):
        want = jax.jit(jproj.apply_projector)(p, jnp.asarray(x))
    with tq.dynamic_act_quant(quant):
        got = tproj.apply_projector(bridge(p), _t(x))
    close(got, want)


@pytest.fixture(scope="module")
def sam_setup():
    cfg = jc.SamConfig.tiny()
    p = jax.jit(lambda k: jsam.init_sam(k, cfg))(jax.random.PRNGKey(4))
    blocks = p["image_encoder"]["blocks"]["attn"]
    # non-zero relative-position tables, so the bias path is exercised
    for k in ("rel_pos_h", "rel_pos_w"):
        blocks[k] = jnp.asarray(randn(*blocks[k].shape, scale=0.1))
    return cfg, p


def test_sam_encode_image(sam_setup):
    """Adapters, windowed (2x2 over a padded 4x4 grid) and global
    attention with relative positions, neck."""
    cfg, p = sam_setup
    img = randn(2, 64, 64, 3)
    close(tsam.encode_image(bridge(p["image_encoder"]), _t(img),
                            port_cfg(cfg)),
          jax.jit(lambda pp, x: jsam.encode_image(pp, x, cfg))(
              p["image_encoder"], jnp.asarray(img)),
          rtol=1e-4, atol=1e-4)


def test_sam_prompt_and_mask_decoder(sam_setup):
    """encode_prompts(text_embeds) + dense_pe + two-way transformer + mask
    decode + postprocess (bilinear 16 -> 64 upsample)."""
    cfg, p = sam_setup
    tcfg = port_cfg(cfg)
    emb, text = randn(3, 4, 4, 32), randn(3, 1, 32)
    pe_j = jsam.dense_pe(p["prompt_encoder"], cfg)
    pe_t = tsam.dense_pe(bridge(p["prompt_encoder"]), tcfg)
    close(pe_t, pe_j)
    sj, dj = jsam.encode_prompts(p["prompt_encoder"], cfg, 3,
                                 text_embeds=jnp.asarray(text))
    st, dt = tsam.encode_prompts(bridge(p["prompt_encoder"]), tcfg, 3,
                                 text_embeds=_t(text))
    close(st, sj)
    close(dt, dj)
    mj, ij = jax.jit(lambda pp, *a: jsam.decode_masks(pp, cfg, *a))(
        p["mask_decoder"], jnp.asarray(emb), pe_j, sj, dj)
    mt, it = tsam.decode_masks(bridge(p["mask_decoder"]), tcfg, _t(emb),
                               pe_t, st, dt)
    close(mt, mj, rtol=1e-4, atol=1e-4)
    close(it, ij, rtol=1e-4, atol=1e-4)
    close(tsam.postprocess_masks(mt, 64),
          jsam.postprocess_masks(mj, 64), rtol=1e-4, atol=1e-4)


def test_postprocess_masks_is_jax_bilinear_upsample():
    """F.interpolate(bilinear, align_corners=False) == jax.image.resize
    (bilinear) for an upsample; 1e-5 (f32 interpolation weights)."""
    m = randn(2, 1, 64, 64)
    close(tsam.postprocess_masks(_t(m), 256),
          jsam.postprocess_masks(jnp.asarray(m), 256))


def test_llama_prefill_and_decode():
    """Dense LLaMA (GQA), prefill writing the cache, then two decode
    steps; hidden states, cache contents and lengths."""
    cfg = jc.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16)
    p = jllama.init_llama(jax.random.PRNGKey(5), cfg)
    tp, tcfg = bridge(p), port_cfg(cfg)
    x = randn(2, 7, 64)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    cache = jllama.KVCache.init(cfg, 2, 10, jnp.float32)
    hj, cj, _ = jllama.forward(p, cfg, jnp.asarray(x), jnp.asarray(mask),
                               cache=cache)
    tcache = tllama.KVCache.init(tcfg, 2, 10, torch.float32, device="cpu")
    ht, ct, _ = tllama.forward(tp, tcfg, _t(x), _t(mask), cache=tcache)
    close(ht, hj)
    close(ct.k, cj.k)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    for step in range(2):
        e = randn(2, 1, 64)
        hj, cj = jllama.forward_decode(p, cfg, jnp.asarray(e), cj)
        ht, ct = tllama.forward_decode(tp, tcfg, _t(e), ct)
        close(ht, hj)
        close(ct.v, cj.v)
        np.testing.assert_array_equal(ct.length.numpy(),
                                      np.asarray(cj.length))
    ids = np.array([[1, -200, 5]])
    close(tllama.embed(tp, _t(ids)), jllama.embed(p, jnp.asarray(ids)),
          rtol=0, atol=0)
    close(tllama.logits(tp, ht), jllama.logits(p, hj))


@pytest.mark.parametrize("mode,actq", [("sort", False), ("sort", True),
                                       ("gmm", False), ("gmm", True)])
def test_moe_mlp_dispatch(mode, actq):
    """One MoE layer with the flagship's int4h(G=2) experts, padded to
    M=1024. sort: exact-order capacity dispatch (1e-5). gmm: the grouped
    matmul (plain K1) over the two-ended aligned buffer; bf16-x mode 1e-4
    (bf16-rounded x); W4A8 rel 1e-3 (a rare act-quant rounding flip from a
    last-bit difference costs one quant step)."""
    _, mcfg, p = _tiny_moe_llm()
    p = jq.quantize_flagship_moe({"llm": p}, 4, 8)["llm"]
    lp = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["moe"])
    x = randn(2, 520, 256, scale=0.5) if mode == "gmm" else randn(2, 9, 256)
    with jq.dynamic_act_quant(actq):
        want, aux_j = jax.jit(lambda m, v: jmoe.moe_mlp(
            m, v, mcfg, train=False, dispatch_mode=mode))(lp, jnp.asarray(x))
    with tq.dynamic_act_quant(actq):
        got, aux_t = tmoe.moe_mlp(bridge(lp), _t(x), port_cfg(mcfg),
                                  train=False, dispatch_mode=mode)
    close(aux_t, aux_j)
    if mode == "sort":
        close(got, want)
    elif not actq:
        close(got, want, rtol=1e-4, atol=1e-4)
    else:
        want = np.asarray(want)
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < 1e-3, rel


def test_moe_gates_match_reference():
    """The auto dispatch and whole-stack eligibility gates."""
    from medplib_tpu.models import moe_llama as jml
    from medplib_tpu_torch.models import moe_llama as tml
    _, mcfg, p = _tiny_moe_llm()
    p = jq.quantize_flagship_moe({"llm": p}, 4, 8)["llm"]
    ex = p["layers"]["moe"]["experts"]
    tex = bridge(ex)
    for s, decode in ((2000, False), (600, False), (16, True), (3, True)):
        want = jml.stack_experts_for_gmm(ex, mcfg, s, False, False,
                                         decode=decode) is not None
        assert tml.stack_experts_for_gmm(tex, port_cfg(mcfg), s, False,
                                         decode=decode) == want
    assert tmoe.capacity_for(623, 2, 2.0, 0) == jmoe.capacity_for(623, 2,
                                                                  2.0, 0)
