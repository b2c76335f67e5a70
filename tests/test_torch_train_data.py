"""The port's training data modules held to the JAX package's on the CPU:
the prefetching loader (data/loader.py), the ICL dataset and collator
(data/icl_dataset.py) and the hybrid multi-task stack (data/hybrid.py).

Inputs are files written from numpy seeds (the fixtures of
tests/test_hybrid.py and tests/test_icl.py) and fake tokenizers whose ids
come from Python's per-process string hash, so both packages see the same
ids in one process. Token ids, labels, masks, slot types and lengths are
held equal; CLIP / SAM pixels within 1e-5 (the JAX default resizes with
its C++ float resampler, the port with its numpy one:
tests/test_torch_data.py)."""

import random

import numpy as np
import pytest
import torch

from medplib_tpu.data import dataset as jds
from medplib_tpu.data import hybrid as jhy
from medplib_tpu.data import icl_dataset as jicl
from medplib_tpu.data import loader as jld
from medplib_tpu_torch.data import dataset as tds
from medplib_tpu_torch.data import hybrid as thy
from medplib_tpu_torch.data import icl_dataset as ticl
from medplib_tpu_torch.data import loader as tld
from test_hybrid import FakeTok as HybridTok
from test_hybrid import hybrid_root  # noqa: F401 - fixture
from test_icl import FakeTok as IclTok
from test_icl import icl_data  # noqa: F401 - fixture
from test_loader import CC as JCC
from test_loader import FakeDataset

PIX = dict(rtol=0, atol=1e-5)


def same_sample(got, want):
    """Equal keys; arrays 1e-5 (pixels) or equal (ids, labels, masks);
    lists of arrays equal; everything else equal."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = got[k]
        if isinstance(v, np.ndarray):
            assert g.shape == v.shape, k
            if v.dtype.kind in "iub" or k in ("input_ids", "labels"):
                np.testing.assert_array_equal(g, v, err_msg=k)
            else:
                np.testing.assert_allclose(g, v, err_msg=k, **PIX)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            assert len(g) == len(v), k
            for a, b in zip(g, v):
                np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert g == v, k


def same_arrays(got, want, pixels=("images_clip", "images_sam")):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k in pixels:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **PIX)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# PrefetchLoader
# ---------------------------------------------------------------------------

def _take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    loader.close()
    return out


@pytest.mark.parametrize("workers", [0, 2])
def test_prefetch_loader_matches_jax(workers):
    """The same index stream (seeded permutation, wrap-around) and equal
    [accum, B, ...] batches as JAX's loader, at 0 and 2 workers, on the
    CPU device; a worker's exception reaches the consumer."""
    ds = FakeDataset(7)
    cc = tds.CollatorConfig(max_seq_len=16, image_tokens=4,
                            sam_image_size=32, clip_image_size=16)
    kw = dict(batch_size=3, accum_steps=2, seed=11)
    jl = jld.PrefetchLoader(ds, JCC, num_workers=workers, **kw)
    tl = tld.PrefetchLoader(ds, cc, num_workers=workers, device="cpu", **kw)
    ji, ti = jl._index_stream(), tl._index_stream()
    for _ in range(5):
        assert next(ti) == next(ji)
    want, got = _take(jl, 3), _take(tl, 3)
    for w, g in zip(want, got):
        assert g._fields == w._fields
        for f in w._fields:
            a, b = getattr(g, f), np.asarray(getattr(w, f))
            assert a.device.type == "cpu" and tuple(a.shape) == b.shape, f
            assert a.shape[:2] == (2, 3), f
            assert str(a.dtype).split(".")[-1] == str(b.dtype), f
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    if workers:
        bad = tld.PrefetchLoader(FakeDataset(8, fail_at=5), cc, batch_size=4,
                                 num_workers=workers, seed=0, device="cpu")
        with pytest.raises(RuntimeError, match="corrupt sample"):
            _take(bad, 3)


def test_stack_batches_keeps_none_fields():
    b = tds.to_model_batch(tds.collate([FakeDataset(2)[0]], tds.CollatorConfig(
        max_seq_len=8, image_tokens=4, sam_image_size=32,
        clip_image_size=16))[0], device="cpu")
    b = b._replace(region_masks=None)
    s = tld.stack_batches([b, b])
    assert s.region_masks is None and tuple(s.input_ids.shape) == (2, 1, 8)
    assert torch.equal(s.input_ids[0], s.input_ids[1])


# ---------------------------------------------------------------------------
# ICL dataset and collator
# ---------------------------------------------------------------------------

ICL_MODES = {"overlay": dict(mask_mode="overlay"),
             "separate": dict(mask_mode="separate"),
             "separate_encoder": dict(mask_mode="separate",
                                      use_mask_encoder=True)}


def _icl_pair(icl_data, **kw):  # noqa: F811
    path, folder = icl_data
    dk = dict(data_path=path, image_folder=folder, sam_image_size=64,
              clip_image_size=56)
    tok = IclTok()
    args = dict(image_tokens=16, mask_tokens=4, **kw)
    return (jicl.ICLLazySupervisedDataset(jds.DataConfig(**dk), tok, **args),
            ticl.ICLLazySupervisedDataset(tds.DataConfig(**dk), tok, **args))


@pytest.mark.parametrize("mode", list(ICL_MODES))
def test_icl_dataset_and_collate_match_jax(icl_data, mode):  # noqa: F811
    """Both record forms (icl_examples; imageN / maskN without a
    conversation) in each encoding: equal samples, then collate_icl
    arrays equal (pixels 1e-5) and equal metadata."""
    jd, td = _icl_pair(icl_data, **ICL_MODES[mode])
    samples_j, samples_t = [], []
    for i in range(len(jd)):
        want, got = jd[i], td[i]
        same_sample(got, want)
        samples_j.append(want)
        samples_t.append(got)
    slots = 7 if mode != "overlay" else 4
    kw = dict(max_seq_len=96, max_segs=1, image_tokens=16,
              sam_image_size=64, clip_image_size=56)
    want, wmeta = jicl.collate_icl(samples_j, jds.CollatorConfig(**kw),
                                   max_slots=slots, mask_tokens=4)
    got, gmeta = ticl.collate_icl(samples_t, tds.CollatorConfig(**kw),
                                  max_slots=slots, mask_tokens=4)
    same_arrays(got, want)
    assert gmeta["question"] == wmeta["question"]
    assert gmeta["resize_hw"] == wmeta["resize_hw"]
    if mode == "separate_encoder":
        assert got["image_is_mask"].sum() >= 1
        assert got["mask_images"].max() == 1.0


# ---------------------------------------------------------------------------
# hybrid multi-task data
# ---------------------------------------------------------------------------

def _hcfg(mod, root, **kw):
    return mod.HybridConfig(base_image_dir=root, sam_image_size=64,
                            clip_image_size=56, samples_per_epoch=32,
                            sem_seg_data=("toy",), refer_seg_data=("toy",),
                            reason_seg_data="ToySeg|train", explanatory=1.0,
                            **kw)


@pytest.mark.parametrize("case", ["polygons", "rle", "coco_polygon"])
def test_mask_decoders_match_jax(case):
    """polygons_to_mask (ignore labels, largest-first painting, 'flag'
    skipped), decode_rle and segmentation_to_mask: equal masks."""
    rng = np.random.default_rng(3)
    if case == "polygons":
        shapes = [{"label": lab, "points": rng.integers(0, 40, (5, 2))
                   .tolist()} for lab in ("big", "ignore_small", "flag",
                                          "other")]
        args = (shapes, 40, 48)
        want, got = jhy.polygons_to_mask(*args), thy.polygons_to_mask(*args)
    elif case == "rle":
        counts = rng.integers(1, 30, 40).tolist()
        counts.append(30 * 40 - sum(counts))
        rle = {"size": [30, 40], "counts": counts}
        want, got = jhy.decode_rle(rle), thy.decode_rle(rle)
        assert np.array_equal(thy.segmentation_to_mask(rle, 30, 40), want)
    else:
        seg = [rng.uniform(0, 40, 8).tolist(), rng.uniform(0, 40, 6).tolist()]
        want = jhy.segmentation_to_mask(seg, 36, 44)
        got = thy.segmentation_to_mask(seg, 36, 44)
    assert got.dtype == want.dtype and want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["sem_seg", "refer_seg", "vqa",
                                    "reason_seg"])
def test_hybrid_source_matches_jax(hybrid_root, source):  # noqa: F811
    """Each source's draws from the same random.Random seeds: equal
    samples, and the generators left in the same state."""
    tok = HybridTok()
    js = jhy._SOURCE_TYPES[source](_hcfg(jhy, hybrid_root), tok)
    ts = thy._SOURCE_TYPES[source](_hcfg(thy, hybrid_root), tok)
    for seed in range(3):
        rj, rt = random.Random(seed), random.Random(seed)
        same_sample(ts.sample(rt), js.sample(rj))
        assert rt.getstate() == rj.getstate()


def test_hybrid_dataset_matches_jax(hybrid_root):  # noqa: F811
    """The rate-weighted mixture: equal samples by index, equal collated
    arrays; the rates are normalized the same way."""
    tok = HybridTok()
    jd = jhy.HybridDataset(_hcfg(jhy, hybrid_root, seed=3), tok,
                           sample_rates=(1, 1, 1, 1))
    td = thy.HybridDataset(_hcfg(thy, hybrid_root, seed=3), tok,
                           sample_rates=(1, 1, 1, 1))
    assert len(td) == len(jd) == 32
    np.testing.assert_array_equal(td.rates, jd.rates)
    idx = list(range(6))
    for i in idx:
        same_sample(td[i], jd[i])
    kw = dict(max_seq_len=96, max_segs=3, sam_image_size=64,
              clip_image_size=56)
    want, _ = jds.collate([jd[i] for i in idx], jds.CollatorConfig(**kw))
    got, _ = tds.collate([td[i] for i in idx], tds.CollatorConfig(**kw))
    same_arrays(got, want)
    with pytest.raises(ValueError, match="sample_rates"):
        thy.HybridDataset(_hcfg(thy, hybrid_root), tok, sample_rates=(1, 2))
