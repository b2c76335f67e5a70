"""The port's SAM prompts, predictor and automatic mask generation
(medplib_tpu_torch/models/sam_med2d.py prompt encoder, sam_predictor.py,
amg.py) held to the JAX package on numpy-seeded inputs, on the CPU.

Model: SamConfig.tiny (f32), the JAX tree from PRNGKey(4) carried across
by utils/convert (test_torch_modules.bridge). Tolerances: prompt
embeddings 1e-5 (f32 sin / cos and convolutions), mask logits and IoU
predictions 1e-4 (a two-way transformer of f32 products in another
order); binarized masks may differ only where a logit lies within that
distance of 0, held to 0.1% of the pixels; box NMS, crops, stability
scores, RLE codecs and the small-region cleanup are exact. The cleanup's
8-connected labelling (scipy, numbered as OpenCV numbers it) is held to
the JAX package's cv2 path on seeded random masks, the all-small tie
included.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import medplib_tpu.config as jc
from medplib_tpu.models import amg as jamg
from medplib_tpu.models import sam_med2d as jsam
from medplib_tpu.models import sam_predictor as jsp
from medplib_tpu_torch.models import amg as tamg
from medplib_tpu_torch.models import sam_med2d as tsam
from medplib_tpu_torch.models import sam_predictor as tsp
from test_torch_modules import bridge, close, port_cfg

torch.set_num_threads(1)
PIX_SHARE = 1e-3        # share of binarized mask pixels that may differ
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def sam():
    cfg = jc.SamConfig.tiny()
    p = jax.jit(lambda k: jsam.init_sam(k, cfg))(jax.random.PRNGKey(4))
    p = jax.tree_util.tree_map(np.asarray, p)
    return cfg, p, port_cfg(cfg), bridge(p)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def test_preprocess_pixels(sam):
    cfg, _, tcfg, _ = sam
    img = _rng(0).integers(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    close(tsam.preprocess_pixels(torch.from_numpy(img), tcfg),
          jsam.preprocess_pixels(jnp.asarray(img), cfg), rtol=0, atol=0)


def test_embed_points_every_label(sam):
    """Labels -1 (pad: not-a-point embedding, no positional term), 0 and
    1 in one batch."""
    cfg, p, tcfg, tp = sam
    rng = _rng(1)
    coords = rng.uniform(0, 64, (3, 5, 2)).astype(np.float32)
    labels = np.array([[-1, 0, 1, 1, 0], [1, -1, -1, 0, 1],
                       [0, 0, 1, -1, 1]], np.float32)
    close(tsam.embed_points(tp["prompt_encoder"], tcfg,
                            torch.from_numpy(coords),
                            torch.from_numpy(labels)),
          jsam.embed_points(p["prompt_encoder"], cfg, jnp.asarray(coords),
                            jnp.asarray(labels)), rtol=1e-5, atol=1e-5)


def test_embed_boxes(sam):
    cfg, p, tcfg, tp = sam
    boxes = np.sort(_rng(2).uniform(0, 64, (4, 2, 2)), axis=1).reshape(
        4, 4).astype(np.float32)
    close(tsam.embed_boxes(tp["prompt_encoder"], tcfg,
                           torch.from_numpy(boxes)),
          jsam.embed_boxes(p["prompt_encoder"], cfg, jnp.asarray(boxes)),
          rtol=1e-5, atol=1e-5)


def test_embed_mask_input(sam):
    """The downscaler: conv k2 s2 -> LN -> GELU, twice, then a 1x1 conv."""
    cfg, p, tcfg, tp = sam
    s = 4 * cfg.image_embedding_size
    m = _rng(3).normal(size=(2, s, s, 1)).astype(np.float32) * 4
    close(tsam.embed_mask_input(tp["prompt_encoder"], torch.from_numpy(m)),
          jax.jit(jsam.embed_mask_input)(p["prompt_encoder"],
                                         jnp.asarray(m)),
          rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pts,box,mask,text",
                         list(itertools.product([False, True], repeat=4)))
def test_encode_prompts_every_combination(sam, pts, box, mask, text):
    """Sparse order (points + pad slot without a box, box corners, text),
    dense from the mask or the no-mask embedding; shapes and values."""
    cfg, p, tcfg, tp = sam
    rng = _rng(5)
    b, s = 2, 4 * cfg.image_embedding_size
    arrays = dict(
        points=(rng.uniform(0, 64, (b, 3, 2)).astype(np.float32),
                np.array([[1, 0, -1], [0, 1, 1]], np.float32)) if pts
        else None,
        boxes=np.array([[4, 6, 40, 50], [10, 2, 60, 30]], np.float32)
        if box else None,
        mask_input=rng.normal(size=(b, s, s, 1)).astype(np.float32)
        if mask else None,
        text_embeds=rng.normal(size=(b, 1, 32)).astype(np.float32)
        if text else None)

    def conv(a, f):
        if a is None:
            return None
        return tuple(f(x) for x in a) if isinstance(a, tuple) else f(a)

    sj, dj = jsam.encode_prompts(p["prompt_encoder"], cfg, b,
                                 **{k: conv(v, jnp.asarray)
                                    for k, v in arrays.items()})
    st_, dt = tsam.encode_prompts(tp["prompt_encoder"], tcfg, b,
                                  **{k: conv(v, torch.from_numpy)
                                     for k, v in arrays.items()})
    assert tuple(st_.shape) == sj.shape and tuple(dt.shape) == dj.shape
    close(st_, sj, rtol=1e-5, atol=1e-5)
    close(dt, dj, rtol=1e-5, atol=1e-5)


def test_encode_prompts_seg_path_unchanged(sam):
    """The SEG path's call returns the text embeddings themselves (any
    dtype) and the broadcast no-mask embedding, as before the point / box /
    mask prompts."""
    _, _, tcfg, tp = sam
    pe = tp["prompt_encoder"]
    for dtype in (torch.float32, torch.bfloat16):
        text = torch.randn(3, 1, 32).to(dtype)
        sparse, dense = tsam.encode_prompts(pe, tcfg, 3, text_embeds=text)
        assert sparse is text
        s = tcfg.image_embedding_size
        assert torch.equal(dense, pe["no_mask_embed"][None, None, None]
                           .expand(3, s, s, 32))


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------

def _mask_share(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == bool
    return float((got != want).mean())


def _image(seed, hw=(48, 80)):
    return _rng(seed).integers(0, 256, hw + (3,)).astype(np.uint8)


@pytest.fixture(scope="module")
def predictors(sam):
    cfg, p, tcfg, tp = sam
    return jsp.SamPredictor(p, cfg), tsp.SamPredictor(tp, tcfg)


@pytest.mark.parametrize("hw", [(48, 80), (80, 48), (64, 64)])
def test_predictor_predict_matches_jax(predictors, hw):
    """Points (multimask), a box (single mask), points + box, then the
    previous low-res logits as mask_input: IoU predictions and low-res
    logits 1e-4, masks within PIX_SHARE."""
    jp, tp = predictors
    img = _image(sum(hw), hw)
    jp.set_image(img)
    tp.set_image(img)
    close(tp.features, jp.features, **LOGIT_TOL)
    h, w = hw
    pts = np.array([[w * 0.5, h * 0.5], [w * 0.2, h * 0.7]])
    calls = [dict(point_coords=pts, point_labels=np.array([1, 0]),
                  multimask_output=True),
             dict(box=np.array([w * 0.1, h * 0.2, w * 0.8, h * 0.9]),
                  multimask_output=False),
             dict(point_coords=pts[:1], point_labels=np.array([1]),
                  box=np.array([2, 3, w - 4, h - 5]),
                  multimask_output=True)]
    for kw in calls:
        mj, ij, lj = jp.predict(**kw)
        mt, it, lt = tp.predict(**kw)
        close(it, ij, **LOGIT_TOL)
        close(lt, lj, **LOGIT_TOL)
        assert _mask_share(mt, mj) <= PIX_SHARE
    # the mask prompt round trip: the last low-res logits fed back
    kw = dict(point_coords=pts[:1], point_labels=np.array([1]),
              mask_input=lj[0], multimask_output=False)
    mj, ij, lj2 = jp.predict(**kw)
    mt, it, lt2 = tp.predict(**kw)
    assert mt.shape == (1, h, w)
    close(it, ij, **LOGIT_TOL)
    close(lt2, lj2, **LOGIT_TOL)
    assert _mask_share(mt, mj) <= PIX_SHARE


def test_predict_needs_set_image(sam):
    _, _, tcfg, tp = sam
    with pytest.raises(AssertionError, match="set_image"):
        tsp.SamPredictor(tp, tcfg).predict(point_coords=np.zeros((1, 2)),
                                           point_labels=np.ones(1))


# ---------------------------------------------------------------------------
# AMG helpers: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_stability_score_mask_to_box_and_nms(seed):
    rng = _rng(10 + seed)
    logits = rng.normal(size=(12, 9, 11)).astype(np.float32) * 2
    for off in (0.5, 1.0):
        np.testing.assert_array_equal(
            tsp.calculate_stability_score(logits, 0.2, off),
            jsp.calculate_stability_score(logits, 0.2, off))
    masks = rng.uniform(size=(12, 9, 11)) > 0.8
    masks[3] = False                                # an empty mask
    np.testing.assert_array_equal(tsp._mask_to_box(masks),
                                  jsp._mask_to_box(masks))
    boxes = tsp._mask_to_box(masks)
    scores = rng.uniform(size=12)
    for thr in (0.0, 0.3, 0.7, 1.0):
        assert tsp._box_nms(boxes, scores, thr) == \
            jsp._box_nms(boxes, scores, thr)
    assert tsp._box_nms(boxes[:0], scores[:0], 0.5) == []


@pytest.mark.parametrize("h,w,layers,ratio", [
    (40, 64, 0, 512 / 1500), (40, 64, 1, 512 / 1500), (97, 53, 2, 0.2),
    (512, 384, 1, 512 / 1500)])
def test_crop_boxes(h, w, layers, ratio):
    assert tsp._crop_boxes(h, w, layers, ratio) == \
        jsp._crop_boxes(h, w, layers, ratio)


# ---------------------------------------------------------------------------
# generate_masks
# ---------------------------------------------------------------------------

def _records_equal(got, want, mode):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["crop_box"] == w["crop_box"]
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        assert g["area"] == w["area"]
        np.testing.assert_allclose(g["predicted_iou"], w["predicted_iou"],
                                   **LOGIT_TOL)
        assert g["stability_score"] == w["stability_score"]
        if mode == "binary_mask":
            np.testing.assert_array_equal(g["segmentation"],
                                          w["segmentation"])
        else:
            assert g["segmentation"] == w["segmentation"]   # RLE, strings


@pytest.mark.parametrize("mode", ["binary_mask", "uncompressed_rle",
                                  "coco_rle"])
@pytest.mark.parametrize("crops,min_region", [(0, 0), (1, 4), (1, 0)])
def test_generate_masks_matches_jax(predictors, mode, crops, min_region):
    """A 4 x 4 grid (2 x 2 on the crops of layer 1 with downscale 2), no
    score filter, the crop pyramid, the small-region cleanup, every output
    mode: the same records in the same order."""
    jp, tp = predictors
    img = _image(7, (40, 64))
    kw = dict(points_per_side=4, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0, min_area=1, box_nms_thresh=0.7,
              crop_n_layers=crops, crop_n_points_downscale_factor=2,
              min_mask_region_area=min_region, output_mode=mode)
    want = jsp.generate_masks(jp, img, **kw)
    got = tsp.generate_masks(tp, img, **kw)
    _records_equal(got, want, mode)
    if mode == "coco_rle":
        for r in got:
            m = tamg.rle_to_mask(tamg.coco_decode_rle(r["segmentation"]))
            assert int(m.sum()) == r["area"]


def test_generate_masks_filters_match_jax(predictors):
    """The default predicted-IoU and stability thresholds and the legacy
    nms_iou_thresh alias: equal (possibly empty) outputs."""
    jp, tp = predictors
    img = _image(8, (40, 64))
    for kw in (dict(points_per_side=3),
               dict(points_per_side=3, pred_iou_thresh=-1e9,
                    stability_score_thresh=1.1),
               dict(points_per_side=3, pred_iou_thresh=-1e9,
                    stability_score_thresh=0.0, nms_iou_thresh=0.9,
                    min_area=30)):
        want = jsp.generate_masks(jp, img, **kw)
        got = tsp.generate_masks(tp, img, **kw)
        if want:
            _records_equal(got, want, "binary_mask")
        else:
            assert got == []


# ---------------------------------------------------------------------------
# RLE codecs and the small-region cleanup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (31, 17), (64, 64)])
def test_rle_codecs_match_jax(shape):
    rng = _rng(sum(shape))
    for density in (0.1, 0.5, 0.9):
        m = rng.uniform(size=shape) > density
        rle = tamg.mask_to_rle(m)
        assert rle == jamg.mask_to_rle(m)
        np.testing.assert_array_equal(tamg.rle_to_mask(rle), m)
        assert tamg.area_from_rle(rle) == jamg.area_from_rle(rle) == m.sum()
        coco = tamg.coco_encode_rle(rle)
        assert coco == jamg.coco_encode_rle(rle)
        assert tamg.coco_decode_rle(coco) == jamg.coco_decode_rle(coco)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=0, max_size=12))
def test_rle_counts_string_matches_jax(counts):
    """Delta coding from index 3, negative deltas (sign extension)."""
    s = tamg._rle_counts_to_string(counts)
    assert s == jamg._rle_counts_to_string(counts)
    assert tamg._rle_string_to_counts(s) == counts


def _cv2_available():
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.mark.parametrize("seed", range(6))
def test_remove_small_regions_matches_cv2(seed):
    """Holes and islands at several thresholds on random masks of random
    sizes, against the JAX package's cv2 connected components."""
    assert _cv2_available(), "the reference path needs cv2"
    rng = _rng(100 + seed)
    for _ in range(40):
        h, w = rng.integers(1, 48, 2)
        m = rng.uniform(size=(h, w)) > rng.uniform(0.3, 0.95)
        for mode in ("holes", "islands"):
            for thr in (1, 2, 4, 9, 10_000):
                got = tamg.remove_small_regions(m, thr, mode)
                want = jamg.remove_small_regions(m, thr, mode)
                assert got[1] == want[1]
                np.testing.assert_array_equal(got[0], want[0])


def test_remove_small_regions_all_small_tie():
    """Every island small and two of the largest size: both packages keep
    the same one, by OpenCV's numbering (the island whose first 2 x 2
    block comes first), not by the raster order of first pixels."""
    m = np.zeros((6, 8), bool)
    m[1, 0:2] = True         # block (0, 0); its first pixel is row 1
    m[0, 4:6] = True         # block (0, 2); the first pixel in raster order
    m[4, 7] = True
    got, ch = tamg.remove_small_regions(m, 100, "islands")
    want, _ = jamg.remove_small_regions(m, 100, "islands")
    assert ch
    np.testing.assert_array_equal(got, want)
    assert np.argwhere(got).tolist() == [[1, 0], [1, 1]]


def test_label_numbering_is_opencvs():
    """_label8's numbers equal cv2.connectedComponentsWithStats' (8-way)
    on masks where the raster order of first pixels differs."""
    import cv2
    rng = _rng(7)
    for _ in range(50):
        m = rng.uniform(size=(33, 25)) > 0.7
        _, want, _, _ = cv2.connectedComponentsWithStats(
            m.astype(np.uint8), 8)
        got, n = tamg._label8(m)
        assert n == want.max() + 1
        np.testing.assert_array_equal(got, want)


def test_postprocess_small_regions_matches_jax():
    """Edited masks get NMS score 0: a pristine duplicate survives; the
    records' fields equal JAX's."""
    rng = _rng(9)
    recs = []
    for i in range(6):
        m = np.zeros((24, 24), bool)
        y, x = rng.integers(0, 12, 2)
        m[y:y + 10, x:x + 10] = True
        if i % 2:
            m[y + 4, x + 4] = False          # a 1-px hole
            m[(y + 15) % 24, (x + 15) % 24] = True   # a 1-px island
        recs.append({"segmentation": m,
                     "bbox": tsp._mask_to_box(m[None])[0],
                     "area": int(m.sum()), "predicted_iou": 0.5 + i / 10})
    got = tamg.postprocess_small_regions([dict(r) for r in recs], 4, 0.5)
    want = jamg.postprocess_small_regions([dict(r) for r in recs], 4, 0.5)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["predicted_iou"] == w["predicted_iou"]
        assert g["area"] == w["area"]
        np.testing.assert_array_equal(g["segmentation"], w["segmentation"])
        np.testing.assert_array_equal(g["bbox"], w["bbox"])


def test_amg_imports_no_cv2():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(tamg))
    names = {a.name for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names}
    mods = {n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)}
    assert "cv2" not in names and "cv2" not in mods
