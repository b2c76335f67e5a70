"""The port's data modules (medplib_tpu_torch/data, eval/seg_metrics.py)
held to the JAX package's on numpy-seeded inputs.

- conversation: every template of conv_templates gives the JAX prompt,
  also with the image-tuple first message of the web UI.
- tokenize: equal ids, labels and masks under a fake tokenizer.
- preprocess: preprocess_sam / preprocess_clip within 1e-5 of the JAX
  default (its C++ float resampler) at nine image sizes; the PIL
  emulation (resize_longest_side) bit-equal to Pillow and to the JAX
  fallback path; the default path within PIL_STEP grey levels of that
  fallback; region grids and resized mask logits equal.
- dataset: collate, to_model_batch and LazySupervisedDataset samples
  equal.
"""

import dataclasses
import random

import numpy as np
import pytest
from PIL import Image

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.data import conversation as jconv
from medplib_tpu.data import dataset as jds
from medplib_tpu.data import preprocess as jpp
from medplib_tpu.data import tokenize as jtk
from medplib_tpu.eval import seg_metrics as jsm
from medplib_tpu_torch.data import conversation as tconv
from medplib_tpu_torch.data import dataset as tds
from medplib_tpu_torch.data import preprocess as tpp
from medplib_tpu_torch.data import tokenize as ttk
from medplib_tpu_torch.eval import seg_metrics as tsm
from test_cli import FakeHFTok, tiny_dataset  # noqa: F401 - fixture

# PIL rounds to uint8 after each of its two passes (half a grey level
# each) and sums 22-bit fixed-point weights (<= 9 taps, two passes): the
# most its result can differ from the float resampler, in grey levels
PIL_STEP = 1.0 + 2 * 9 * 255 / 2 ** 22


def _img(h, w, seed=0, c=3):
    shape = (h, w, c) if c else (h, w)
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.uint8)


# ---------------------------------------------------------------------------
# conversation
# ---------------------------------------------------------------------------

TEMPLATES = sorted(jconv.conv_templates)


def test_templates_are_the_same_set():
    assert sorted(tconv.conv_templates) == TEMPLATES
    assert [s.name for s in tconv.SeparatorStyle] == \
        [s.name for s in jconv.SeparatorStyle]


def _talk(mod, name, first):
    conv = mod.conv_templates[name].copy()
    conv.append_message(conv.roles[0], first)
    conv.append_message(conv.roles[1], "It shows a <SEG> lesion.")
    conv.append_message(conv.roles[0], "And the <region></region> here?")
    conv.append_message(conv.roles[1], None)
    return conv


def _prompt(conv):
    """get_prompt(), or the name of the error it raises (the plain
    template has no sep2 and fails on a second message, in both)."""
    try:
        return conv.get_prompt()
    except TypeError as e:
        return type(e).__name__


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_prompt(name):
    j = _talk(jconv, name, "<image>\nWhat is in the image?")
    t = _talk(tconv, name, "<image>\nWhat is in the image?")
    assert _prompt(t) == _prompt(j)
    assert t.copy().messages == j.copy().messages
    # copy() detaches the message list, as in JAX
    assert len(tconv.conv_templates[name].messages) == \
        len(jconv.conv_templates[name].messages)


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_image_tuple_prompt(name):
    msg = ("<image>\nDescribe the scan.", "IMAGE-BYTES", "Default")
    j = _talk(jconv, name, msg)
    t = _talk(tconv, name, msg)
    assert _prompt(t) == _prompt(j)
    for conv in (j, t):    # the image message alone: no error
        conv.messages = conv.messages[:1]
    assert t.get_prompt() == j.get_prompt()


# ---------------------------------------------------------------------------
# tokenize
# ---------------------------------------------------------------------------

class NoPadTok(FakeHFTok):
    pad_token = None


@pytest.mark.parametrize("cls", [FakeHFTok, NoPadTok])
def test_add_special_tokens(cls):
    jt, tt = cls(), cls()
    assert ttk.add_special_tokens(tt) == jtk.add_special_tokens(jt)
    assert tt.extra == jt.extra and tt.pad_token == jt.pad_token
    assert tc.EXTRA_TOKENS == jc.EXTRA_TOKENS
    assert (tc.DEFAULT_IMAGE_TOKEN, tc.DEFAULT_IM_START_TOKEN,
            tc.DEFAULT_IM_END_TOKEN) == (jc.DEFAULT_IMAGE_TOKEN,
                                         jc.DEFAULT_IM_START_TOKEN,
                                         jc.DEFAULT_IM_END_TOKEN)


def _tok():
    tok = FakeHFTok()
    jtk.add_special_tokens(tok)
    return tok


@pytest.mark.parametrize("prompt", [
    "USER: <image>\nWhat is this? ASSISTANT:",
    "<image>\nIs the <region> </region> lesion benign?",
    "no image here at all",
    "A <image> B <image> C <region> </region> <region> </region> end"])
def test_tokenizer_image_token(prompt):
    tok = _tok()
    assert ttk.tokenizer_image_token(prompt, tok) == \
        jtk.tokenizer_image_token(prompt, tok)


@pytest.mark.parametrize("use_im_start_end", [False, True])
def test_preprocess_multimodal(use_im_start_end):
    src = [[{"from": "human", "value": "What is this <image> scan?"},
            {"from": "gpt", "value": "A CT."}],
           [{"from": "human", "value": "<image> one <image> two"},
            {"from": "gpt", "value": "Both."}]]
    import copy
    assert ttk.preprocess_multimodal(copy.deepcopy(src), use_im_start_end) \
        == jtk.preprocess_multimodal(copy.deepcopy(src), use_im_start_end)


@pytest.mark.parametrize("has_image", [False, True])
def test_preprocess_v1(has_image):
    tok = _tok()
    src = [[{"from": "human", "value": "<image>\nSegment the lesion."},
            {"from": "gpt", "value": "It is <SEG> ."},
            {"from": "human", "value": "And the <region> </region> one?"},
            {"from": "gpt", "value": "Benign."}]]
    j = jtk.preprocess_v1(src, tok, jconv.conv_templates["llava_v1"],
                          has_image=has_image)
    t = ttk.preprocess_v1(src, tok, tconv.conv_templates["llava_v1"],
                          has_image=has_image)
    for a, b in zip(t["input_ids"] + t["labels"],
                    j["input_ids"] + j["labels"]):
        np.testing.assert_array_equal(a, b)
    assert (t["conversations"], t["question"], t["gt"]) == \
        (j["conversations"], j["question"], j["gt"])
    assert (t["labels"][0] != -100).any()


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

SIZES = [(512, 640), (1024, 1280), (20, 30), (1, 7), (300, 1), (17, 333),
         (333, 17), (256, 256), (181, 243)]


@pytest.mark.parametrize("hw", SIZES)
def test_preprocess_matches_jax_default(hw):
    """The JAX default (its C++ float resampler) within 1e-5 abs."""
    from medplib_tpu import native
    assert native.available()
    img = _img(*hw, seed=hw[0])
    want, want_hw = jpp.preprocess_sam(img, 256)
    got, got_hw = tpp.preprocess_sam(img, 256)
    assert got_hw == want_hw and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpp.preprocess_clip(img, 336),
                               jpp.preprocess_clip(img, 336), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(512, 640), (20, 30), (17, 333),
                                (256, 256)])
def test_preprocess_against_jax_pil_path(hw, monkeypatch):
    """JAX without its C++ library: the port's PIL emulation gives its
    result exactly; the port's default is within PIL_STEP grey levels."""
    monkeypatch.setattr(jpp, "USE_NATIVE", False)
    img = _img(*hw, seed=7)
    want, want_hw = jpp.preprocess_sam(img, 256)
    got, got_hw = tpp.preprocess_sam(img, 256)
    assert got_hw == want_hw
    np.testing.assert_allclose(
        got, want, rtol=0, atol=PIL_STEP / tpp.SAM_PIXEL_STD.min() + 1e-5)
    pil = tpp.resize_longest_side(img, 256).astype(np.float32)
    np.testing.assert_array_equal(
        tpp.center_pad((pil - tpp.SAM_PIXEL_MEAN) / tpp.SAM_PIXEL_STD, 256,
                       0.0), want)
    want = jpp.preprocess_clip(img, 336)
    np.testing.assert_allclose(
        tpp.preprocess_clip(img, 336), want, rtol=0,
        atol=PIL_STEP / 255 / tpp.CLIP_STD.min() + 1e-5)
    pil = tpp.resize_longest_side(img, 336).astype(np.float32)
    padded = tpp.center_pad(pil, 336, tpp.CLIP_PAD_VALUE.astype(np.float32))
    np.testing.assert_array_equal(
        (padded / 255.0 - tpp.CLIP_MEAN) / tpp.CLIP_STD, want)


@pytest.mark.parametrize("hw,c,out", [
    ((40, 50), 0, (17, 23)), ((40, 50), 3, (97, 121)), ((1, 9), 3, (3, 4)),
    ((512, 640), 0, (269, 336)), ((33, 65), 3, (33, 130)),
    ((64, 64), 0, (64, 64))])
def test_pil_bilinear_resize_is_pillow(hw, c, out):
    img = _img(*hw, seed=3, c=c)
    want = np.asarray(Image.fromarray(img).resize(out[::-1],
                                                  Image.BILINEAR))
    np.testing.assert_array_equal(tpp.pil_bilinear_resize(img, *out), want)
    f = np.random.default_rng(4).normal(size=hw).astype(np.float32) * 9
    want = np.asarray(Image.fromarray(f, mode="F").resize(out[::-1],
                                                          Image.BILINEAR))
    np.testing.assert_array_equal(tpp.pil_bilinear_resize(f, *out), want)


def _blobs(h, w, seed, n=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), np.uint8)
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(2, h / 3), rng.uniform(2, w / 3)
        m |= (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1).astype(
            np.uint8)
    return m


@pytest.mark.parametrize("hw,seed", [((512, 640), 0), ((97, 131), 1),
                                     ((1000, 333), 2), ((24, 30), 3),
                                     ((336, 336), 4)])
def test_region_mask_grid_equal(hw, seed):
    m = _blobs(*hw, seed)
    got = tpp.preprocess_region_mask(m, 336, 14)
    want = jpp.preprocess_region_mask(m, 336, 14)
    assert got.shape == (24, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 24 * 24 or hw == (24, 30)


@pytest.mark.parametrize("resize_hw,original_hw", [
    ((205, 256), (512, 640)), ((256, 171), (300, 200)),
    ((64, 48), (40, 30)), ((256, 256), (256, 256))])
def test_unpad_and_resize_mask(resize_hw, original_hw):
    logits = np.random.default_rng(5).normal(size=(256, 256)).astype(
        np.float32) * 6
    got = tpp.unpad_and_resize_mask(logits, resize_hw, original_hw)
    want = jpp.unpad_and_resize_mask(logits, resize_hw, original_hw)
    assert got.shape == tuple(original_hw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sub_component_augment(seed):
    m = _blobs(24, 24, seed + 10, n=3).astype(np.float32)
    got = tpp.sub_component_augment(m, rng=random.Random(seed))
    want = jpp.sub_component_augment(m, rng=random.Random(seed))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(
        tpp._connected_components(m.astype(np.uint8)),
        jpp._connected_components(m.astype(np.uint8)))


def test_load_image_rgb(tmp_path):
    img = _img(21, 34, seed=9)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(tpp.load_image_rgb(path),
                                  jpp.load_image_rgb(path))


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

def _sample(i, n_tok):
    img = _img(40 + i, 50, seed=i)
    sam, hw = tpp.preprocess_sam(img, 64)
    return {"input_ids": np.arange(1, n_tok + 1, dtype=np.int64),
            "labels": np.full(n_tok, -100, np.int64),
            "image_clip": tpp.preprocess_clip(img, 56), "image_sam": sam,
            "resize_hw": hw, "original_hw": img.shape[:2],
            "region_masks": [tpp.preprocess_region_mask(_blobs(40, 50, i),
                                                        56, 14)],
            "gt_masks": [np.ones((64, 64), np.float32)],
            "gt_masks_original": [], "question": ["q"], "gt": ["a"],
            "image_path": None, "answer_type": None}


def test_collate_and_to_model_batch():
    samples = [_sample(0, 9), _sample(1, 40)]
    kw = dict(max_seq_len=32, image_tokens=16, sam_image_size=64,
              clip_image_size=56)
    got, gmeta = tds.collate(samples, tds.CollatorConfig(**kw))
    want, wmeta = jds.collate(samples, jds.CollatorConfig(**kw))
    assert got.keys() == want.keys() and gmeta == wmeta
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    tb, jb = tds.to_model_batch(got, device="cpu"), jds.to_model_batch(want)
    assert tb._fields == jb._fields
    for f in jb._fields:
        a, b = getattr(tb, f), np.asarray(getattr(jb, f))
        assert a.device.type == "cpu"
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f
        np.testing.assert_array_equal(a.numpy(), b)
    assert dataclasses.asdict(tds.CollatorConfig()) == \
        dataclasses.asdict(jds.CollatorConfig())


@pytest.mark.parametrize("train", [True, False])
def test_lazy_supervised_dataset(tiny_dataset, train):  # noqa: F811
    path, folder = tiny_dataset
    kw = dict(data_path=path, image_folder=folder, sam_image_size=64,
              clip_image_size=56)
    tok = _tok()
    jd = jds.LazySupervisedDataset(jds.DataConfig(**kw), tok, train=train)
    td = tds.LazySupervisedDataset(tds.DataConfig(**kw), tok, train=train)
    assert len(td) == len(jd) == 2
    for i in range(2):
        random.seed(i)
        np.random.seed(i)
        want = jd[i]
        random.seed(i)
        np.random.seed(i)
        got = td[i]
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5)
            elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
                assert len(got[k]) == len(v)
                for a, b in zip(got[k], v):
                    np.testing.assert_array_equal(a, b)
            else:
                assert got[k] == v, k


# ---------------------------------------------------------------------------
# seg metrics
# ---------------------------------------------------------------------------

def test_seg_metrics():
    rng = np.random.default_rng(11)
    recs = [{"pred_logits": rng.normal(size=(20, 30)) * 3,
             "gt_mask": rng.integers(0, 2, size=(20, 30)),
             "image_path": p} for p in ("a/ct_1.png", "mr_2.png",
                                        "x_ray_9.png", "odd.png", None)]
    np.testing.assert_array_equal(
        tsm.binarize_logits(recs[0]["pred_logits"]),
        jsm.binarize_logits(recs[0]["pred_logits"]))
    assert tsm.evaluate_seg(recs) == jsm.evaluate_seg(recs)
    assert [tsm.modality_of(r["image_path"]) for r in recs] == \
        [jsm.modality_of(r["image_path"]) for r in recs]
    pred = rng.integers(0, 2, size=(7, 9))
    tgt = rng.integers(0, 2, size=(7, 9))
    tgt[0, 0] = 255
    for a, b in zip(tsm.intersection_and_union(pred, tgt),
                    jsm.intersection_and_union(pred, tgt)):
        np.testing.assert_array_equal(a, b)
    tm, jm = tsm.SegMeter(), jsm.SegMeter()
    for r in recs:
        for m in (tm, jm):
            m.update(r["pred_logits"] > 0, r["gt_mask"])
    assert tm.results() == jm.results()
