"""Region VQA and the ICL token compressor / mask encoder of
medplib_tpu_torch against the JAX package on the CPU, with the same inputs
(numpy seeds) and the same params (the JAX init bridged leaf for leaf).

Modules (float32 unless a test says otherwise): the bilinear sampling and
adaptive pooling matrices equal; region_pool, the compressor and the mask
encoder within 1e-5 (relative and absolute; the mask encoder's
convolutions 1e-4: four layers of sums in another order); region_pool in
bf16 within 2^-6 of the largest output (two bf16 steps), both sides
rounding the same matrices to bf16 first; point sampling, FPS and kNN
indices exactly equal, also at full width (24 x 24 masks, B·M = 16); the
geo sampler's output within 1e-4.

`generate` end to end against jax.jit(generate) on MedplibConfig.tiny()
(float32, the embedding table scaled to unit size so that last-bit
differences cannot swing a greedy choice): rp_flag through the region
adapter and through the geo sampler, ground=False (zero masks), out_size,
and the ICL compressor with the mask encoder. Tokens, has_seg and
seg_valid equal; masks within rel 1e-4 (float32 with no activation
quant: the slice tests' 2e-2 covers W8A8's act-quant flips; these runs
measure ~1e-6). `model_forward(rp_flag=True)`: losses within
1e-5 relative and the gradients of the region adapter, projector and
text_hidden_fcs within 2e-4 of each leaf's largest entry
(tests/test_torch_train_slice.py's tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import geo_sampler as jgeo
from medplib_tpu.models import medplib as jm
from medplib_tpu.models import projector as jproj
from medplib_tpu_torch.models import geo_sampler as tgeo
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.models import projector as tproj
from medplib_tpu_torch.utils import convert

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def bridge(tree):
    return convert.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                   device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def randn(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def region_masks(b, m, g, rng):
    """Random blobs of varied sizes, one single cell, one empty (invalid)."""
    masks = (rng.uniform(size=(b, m, g, g))
             > rng.uniform(0.2, 0.95, size=(b, m, 1, 1))).astype(np.float32)
    masks[0, 0] = 0
    masks[0, 0, 1, 2] = 1
    masks[-1, -1] = 0
    valid = masks.reshape(b, m, -1).sum(-1) > 0
    return masks, valid


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(4, 4), (24, 24), (3, 5)])
def test_bilinear_sample_matrix_equal(hw):
    np.testing.assert_array_equal(tproj._bilinear_sample_matrix(*hw),
                                  jproj._bilinear_sample_matrix(*hw))


@pytest.mark.parametrize("n", [(576, 256), (441, 64), (16, 8), (7, 3)])
def test_adaptive_pool_matrix_equal(n):
    np.testing.assert_array_equal(tproj._adaptive_pool_matrix(*n),
                                  jproj._adaptive_pool_matrix(*n))


def test_region_pool():
    b, m, g, c = 2, 3, 6, 16
    fmap = randn(b, g * g, c)
    masks, valid = region_masks(b, m, g, RNG)
    want = jproj.region_pool(jnp.asarray(fmap), jnp.asarray(masks),
                             jnp.asarray(valid))
    got = tproj.region_pool(_t(fmap), _t(masks), _t(valid))
    close(got, want)
    assert not got[-1, -1].any()            # an invalid mask gives zeros
    # bf16: the matrix, the weights and the product rounded to bf16 on
    # both sides
    want = jproj.region_pool(jnp.asarray(fmap, jnp.bfloat16),
                             jnp.asarray(masks), jnp.asarray(valid))
    got = tproj.region_pool(_t(fmap).bfloat16(), _t(masks), _t(valid))
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - w).max() <= 2 ** -6 * np.abs(w).max()


def test_token_compressor():
    h = 32
    jp = jproj.init_token_compressor(jax.random.PRNGKey(0), h)
    jp["norm"]["weight"] = jnp.asarray(randn(h))
    jp["norm"]["bias"] = jnp.asarray(randn(h))
    x = randn(2, 24, h)
    want = jproj.apply_token_compressor(jp, jnp.asarray(x), 10)
    got = tproj.apply_token_compressor(bridge(jp), _t(x), 10)
    assert tuple(got.shape) == (2, 10, h)
    close(got, want)


def test_mask_encoder():
    h = 32
    jp = jproj.init_mask_encoder(jax.random.PRNGKey(1), h)
    for conv in jp["convs"]:
        conv["bias"] = jnp.asarray(randn(*conv["bias"].shape) * 0.1)
    masks = (RNG.uniform(size=(3, 56, 56)) > 0.6).astype(np.float32)
    want = jproj.apply_mask_encoder(jp, jnp.asarray(masks), 4)
    got = tproj.apply_mask_encoder(bridge(jp), _t(masks), 4)
    assert tuple(got.shape) == (3, 4, h)
    close(got, want, rtol=1e-4, atol=1e-4)


def test_mask_encoder_and_compressor_inits_match_the_jax_tree():
    gen = torch.Generator().manual_seed(0)
    for jt, tt in ((jproj.init_mask_encoder(jax.random.PRNGKey(0), 32),
                    tproj.init_mask_encoder(gen, 32, device="cpu")),
                   (jproj.init_token_compressor(jax.random.PRNGKey(0), 32),
                    tproj.init_token_compressor(gen, 32, device="cpu"))):
        jl = jax.tree_util.tree_flatten_with_path(jt)[0]
        tl = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(lambda x: x.numpy(), tt))[0]
        assert [(p, v.shape) for p, v in jl] == [(p, v.shape) for p, v in tl]


def _jax_points(masks, n):
    return np.stack([np.asarray(jgeo.sample_mask_points(jnp.asarray(mk), n))
                     for mk in masks])


@pytest.mark.parametrize("g, bm", [(4, 6), (24, 16)])
def test_point_sampling_fps_and_knn_indices_equal(g, bm):
    """Both stages of the geo sampler: 512 points per mask, FPS to 128 and
    kNN 24, then FPS to 32 and kNN 24 among the 128."""
    rng = np.random.default_rng(g)
    masks = region_masks(1, bm, g, rng)[0][0]
    masks[-1] = 1.0                                      # a full mask
    pts_j = _jax_points(masks, 512)
    pts_t = tgeo.sample_mask_points(_t(masks), 512)
    np.testing.assert_array_equal(pts_t.numpy(), pts_j)
    fps = jax.jit(jgeo.farthest_point_sample, static_argnums=1)
    knn = jax.jit(jgeo.knn, static_argnums=2)
    for nsub in (128, 32):
        fj = np.stack([np.asarray(fps(jnp.asarray(p), nsub)) for p in pts_j])
        ft = tgeo.farthest_point_sample(_t(pts_j), nsub).numpy()
        np.testing.assert_array_equal(ft, fj)
        new = np.take_along_axis(pts_j, fj[..., None], 1)
        kj = np.stack([np.asarray(knn(jnp.asarray(a), jnp.asarray(q), 24))
                       for a, q in zip(pts_j, new)])
        kt = tgeo.knn(_t(pts_j), _t(new), 24).numpy()
        np.testing.assert_array_equal(kt, kj)
        pts_j = new


def test_geo_sampler():
    b, m, g, c, out = 2, 3, 4, 16, 24
    jp = jgeo.init_geo_sampler(jax.random.PRNGKey(2), c, out)
    fmap = randn(b, g * g, c)
    masks, valid = region_masks(b, m, g, RNG)
    want = jax.jit(jgeo.apply_geo_sampler)(jp, jnp.asarray(fmap),
                                           jnp.asarray(masks),
                                           jnp.asarray(valid))
    got = tgeo.apply_geo_sampler(bridge(jp), _t(fmap), _t(masks), _t(valid))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, m, out)
    close(got, want, rtol=1e-4, atol=1e-4)
    assert not got[-1, -1].any()
    # bf16 params and features: JAX promotes to float32 against the
    # coordinates, so does the port
    jb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    want = jax.jit(jgeo.apply_geo_sampler)(jb, jnp.asarray(fmap,
                                                           jnp.bfloat16),
                                           jnp.asarray(masks),
                                           jnp.asarray(valid))
    got = tgeo.apply_geo_sampler(bridge(jb), _t(fmap).bfloat16(), _t(masks),
                                 _t(valid))
    assert got.dtype == torch.float32
    close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# generate and model_forward
# ---------------------------------------------------------------------------

def region_batch(cfg, b, t, rng, compress=False):
    """benchmarks/run_all.py _vqa_batch(region=True): the bench batch with
    no SEG in the prompt, a region marker at 4 and a g/3 x g/3 mask, plus
    a second row mask shape so the rows differ."""
    batch = ge._make_batch(cfg, b, t, rng)
    ids = np.array(batch.input_ids)
    ids[:, t - 3] = 9
    ids[:, 4] = jc.REGION_TOKEN_INDEX
    g = int(round(cfg.vision.num_patches ** 0.5))
    rm = np.zeros((b, 1, g, g), np.float32)
    rm[:, :, : max(1, g // 3), : max(1, g // 3)] = 1.0
    rm[1:, :, g // 2:, 1:] = 1.0
    n_tok = (cfg.projector.compress_tokens if compress
             else cfg.vision.num_patches)
    return batch._replace(
        input_ids=jnp.asarray(ids), region_masks=jnp.asarray(rm),
        region_valid=jnp.ones_like(batch.region_valid),
        image_token_lengths=jnp.full_like(batch.image_token_lengths, n_tok))


def icl_mask_batch(cfg, b, t, rng):
    """Three image slots per row (query + 2 examples); slot 2 of every row
    is an example MASK (image_is_mask) fed through the mask encoder."""
    n_img, ms = 3, cfg.projector.mask_input_size
    ids = rng.integers(3, min(cfg.llm.vocab_size, cfg.seg_token_idx),
                       size=(b, t))
    ids[:, 0] = 1
    for k in range(n_img):
        ids[:, 2 + 2 * k] = jc.IMAGE_TOKEN_INDEX
    ids[:, t - 3] = cfg.seg_token_idx
    vs, ss = cfg.vision.image_size, cfg.sam.image_size
    is_mask = np.zeros((b, n_img), np.int32)
    is_mask[:, 2] = 1
    lens = np.full((b, n_img), cfg.projector.compress_tokens, np.int32)
    lens[:, 2] = cfg.projector.mask_encoder_tokens
    return jm.Batch.make(
        input_ids=jnp.asarray(ids), input_mask=jnp.ones((b, t), jnp.int32),
        labels=jnp.asarray(ids),
        images_clip=jnp.asarray(rng.normal(
            size=(b, n_img, vs, vs, 3)).astype(np.float32)),
        images_sam=jnp.asarray(rng.uniform(
            0, 255, size=(b, ss, ss, 3)).astype(np.float32)),
        image_token_lengths=jnp.asarray(lens),
        image_is_mask=jnp.asarray(is_mask),
        mask_images=jnp.asarray((rng.uniform(size=(b, n_img, ms, ms))
                                 > 0.5).astype(np.float32)),
        mask_size=ms, sam_frame=ss)


def _torch_batch(batch):
    return tm.Batch(**{k: torch.from_numpy(np.array(getattr(batch, k)))
                       for k in tm.Batch._fields})


def _model(cfg, seed=0):
    p = jm.init_medplib(jax.random.PRNGKey(seed), cfg)
    p["llm"]["embed_tokens"]["embedding"] = \
        p["llm"]["embed_tokens"]["embedding"] * 50.0
    return p, bridge(p)


def _compare(got, want, b, out):
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    np.testing.assert_array_equal(got.has_seg.numpy(),
                                  np.asarray(want.has_seg))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    pm, wm = got.pred_masks.numpy(), np.asarray(want.pred_masks)
    assert pm.shape == wm.shape == (b, 1, out, out)
    if not wm.any():
        assert not pm.any()
    else:
        assert rel(pm, wm) < 1e-4


GEN_CASES = {
    # name: (projector overrides, generate kwargs, compressed tokens)
    "adapter": ({}, dict(out_size=48), False),
    "adapter_ungrounded": ({}, dict(ground=False), False),
    "geo_sampler": (dict(region_geo_sampler=True), {}, False),
    "compressor_ungrounded": (dict(token_compress=True, compress_tokens=6),
                              dict(ground=False, out_size=32), True),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_region_generate_matches_jax(case):
    over, kw, compress = GEN_CASES[case]
    cfg = jc.MedplibConfig.tiny()
    cfg = dataclasses.replace(cfg, projector=dataclasses.replace(
        cfg.projector, **over))
    jp, tp = _model(cfg)
    b, t, new = 3, 16, 4
    batch = region_batch(cfg, b, t, np.random.default_rng(1), compress)
    want = jax.jit(lambda p, bb: jm.generate(
        p, cfg, bb, max_new_tokens=new, rp_flag=True, **kw))(jp, batch)
    got = tm.generate(tp, port_cfg(cfg), _torch_batch(batch),
                      max_new_tokens=new, rp_flag=True, **kw)
    _compare(got, want, b, kw.get("out_size", cfg.sam.image_size))


def test_region_splice_matches_jax():
    """The spliced embeddings with region features, adapter and geo."""
    for geo in (False, True):
        cfg = jc.MedplibConfig.tiny()
        cfg = dataclasses.replace(cfg, projector=dataclasses.replace(
            cfg.projector, region_geo_sampler=geo))
        jp, tp = _model(cfg, seed=3)
        batch = region_batch(cfg, 2, 16, np.random.default_rng(4))
        ej, _, mj, _, _ = jax.jit(lambda p, bb: jm.splice_batch(
            p, cfg, bb, need_region=True))(jp, batch)
        et, _, mt, _, sm = tm.splice_batch(tp, port_cfg(cfg),
                                           _torch_batch(batch),
                                           need_region=True)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        assert bool(sm.is_region.any())
        close(et, ej, rtol=1e-4, atol=1e-4)


def test_icl_compressor_and_mask_encoder_generate_matches_jax():
    cfg = jc.with_icl(jc.MedplibConfig.tiny(), token_compress=True,
                      mask_encoder=True)
    assert port_cfg(cfg) == tc.with_icl(tc.MedplibConfig(
        **{f.name: port_cfg(getattr(jc.MedplibConfig.tiny(), f.name))
           for f in dataclasses.fields(jc.MedplibConfig)}),
        token_compress=True, mask_encoder=True)
    jp, tp = _model(cfg, seed=1)
    assert set(tp) == set(jp) and "mask_encoder" in tp
    b, t, new = 2, 16, 4
    batch = icl_mask_batch(cfg, b, t, np.random.default_rng(2))
    want = jax.jit(lambda p, bb: jm.generate(
        p, cfg, bb, max_new_tokens=new))(jp, batch)
    tb = _torch_batch(batch)
    got = tm.generate(tp, port_cfg(cfg), tb, max_new_tokens=new)
    _compare(got, want, b, cfg.sam.image_size)
    ej, _, mj, _, _ = jax.jit(lambda p, bb: jm.splice_batch(
        p, cfg, bb, need_region=False))(jp, batch)
    et, _, mt, _, _ = tm.splice_batch(tp, port_cfg(cfg), tb)
    per = max(cfg.projector.compress_tokens, cfg.projector.mask_encoder_tokens)
    assert et.shape[1] == tm._out_len(port_cfg(cfg), tb) == t + 3 * (per - 1)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    close(et, ej, rtol=1e-4, atol=1e-4)


def test_model_forward_rp_flag_losses_and_grads_match_jax():
    cfg = jc.MedplibConfig.tiny()
    jp, _ = _model(cfg, seed=5)
    batch = region_batch(cfg, 2, 16, np.random.default_rng(6))
    ids = np.array(batch.input_ids)
    ids[:, 13] = cfg.seg_token_idx                  # one SEG per row
    batch = batch._replace(input_ids=jnp.asarray(ids),
                           labels=jnp.asarray(ids))
    names = ("region_fea_adapter", "mm_projector", "text_hidden_fcs")

    def loss(sub):
        out = jm.model_forward({**jp, **sub}, cfg, batch, rp_flag=True,
                               remat=False)
        return out["loss"], {k: v for k, v in out.items() if v.ndim == 0}

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {n: jp[n] for n in names})
    tp = bridge(jp)
    leaves = {n: jax.tree_util.tree_map(
        lambda x: x.requires_grad_(True), tp[n]) for n in names}
    tp.update(leaves)
    out = tm.model_forward(tp, port_cfg(cfg), _torch_batch(batch),
                           rp_flag=True, remat=False)
    assert set(out) == set(jout)
    for k, v in jout.items():
        np.testing.assert_allclose(float(out[k].detach()), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    tl = jax.tree_util.tree_leaves(leaves)
    wl = jax.tree_util.tree_leaves(jgrads)
    grads = torch.autograd.grad(out["loss"], tl)
    for g, w in zip(grads, wl):
        w = np.asarray(w, np.float32)
        tol = max(2e-4 * float(np.abs(w).max()), 1e-7)
        assert np.all(np.abs(g.numpy() - w) <= tol)
    ga = jax.tree_util.tree_leaves(jgrads["region_fea_adapter"])
    assert all(np.abs(np.asarray(x)).max() > 0 for x in ga)


def test_batch_make_defaults():
    """The JAX package's Batch.make defaults, field for field."""
    cfg = jc.MedplibConfig.tiny()
    full = ge._make_batch(cfg, 2, 8, np.random.default_rng(0))
    first = [getattr(full, k) for k in jm.Batch._fields[:6]]
    jb = jm.Batch.make(*first, sam_frame=cfg.sam.image_size)
    tb = tm.Batch.make(*[_t(x) for x in first], sam_frame=cfg.sam.image_size)
    assert tm.Batch._fields == jm.Batch._fields
    for k in tm.Batch._fields[6:]:
        a, w = getattr(tb, k), np.asarray(getattr(jb, k))
        assert a.shape == w.shape and a.numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(a.numpy(), w)
