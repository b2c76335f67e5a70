"""The port's image retrieval (medplib_tpu_torch/rag/image_rag.py) held to
the JAX package's on the CPU: the cases of tests/test_rag.py and
tests/test_icl_rag_e2e.py.

- ImageRagEncoder: embeddings of seeded non-square PNGs within 1e-5 of
  the JAX encoder's (the same tiny CLIP tree; f32), unit norm.
- build_index / augment: equal metadata and icl_examples, embeddings
  within 1e-5; an index built by either package is read by the other.
- make_encoder: each of the four types from MEDPLIB_RAG_ENCODER_ROOT
  (save_params files), an unknown type rejected; the record schema
  (collect_candidates) equal to JAX's.
- main: build and augment on the CPU (--device cpu; the default is cuda).
- an augmented record feeds the port's ICL dataset and collator (equal
  arrays; pixels within 1e-5, the port's resampler) and its generate:
  equal tokens to the JAX generate (jax.jit) on the same batch and tree,
  masks within 1e-4.
"""

import dataclasses
import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
from medplib_tpu.data import dataset as jds
from medplib_tpu.data import icl_dataset as jicl
from medplib_tpu.models import clip as jclip
from medplib_tpu.models import medplib as jm
from medplib_tpu.rag import image_rag as jrag
from medplib_tpu_torch.data import dataset as tds
from medplib_tpu_torch.data import icl_dataset as ticl
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.rag import image_rag as trag
from medplib_tpu_torch.utils.checkpoint import save_params
from test_torch_modules import bridge, close, port_cfg, snap

torch.set_num_threads(1)
EMB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def encoders():
    cfg = jc.ClipVisionConfig.tiny()
    p = snap(jclip.init_clip_vision(jax.random.PRNGKey(0), cfg))
    return (jrag.ImageRagEncoder(p, cfg, batch_size=4),
            trag.ImageRagEncoder(bridge(p), port_cfg(cfg), batch_size=4),
            cfg, p)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seven seeded images of several sizes with masks, candidates in
    three record forms, and a test file of two queries."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("rag")
    rng = np.random.default_rng(0)
    sizes = [(40, 40), (48, 64), (64, 48), (30, 70), (56, 56), (41, 39),
             (60, 20)]
    for i, hw in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, hw + (3,)).astype(
            np.uint8)).save(tmp / f"c{i}.png")
        m = np.zeros(hw, np.uint8)
        m[hw[0] // 4:hw[0] // 2, hw[1] // 4:hw[1] // 2] = 255
        Image.fromarray(m).save(tmp / f"cm{i}.png")
    cands = [{"image": f"c{i}.png", "conversations": [
        {"from": "gpt", "value": f"<SEG> <mask>cm{i}.png</mask>"}]}
        for i in range(4)]
    cands.append({"image2": "c4.png", "mask2": "cm4.png"})
    cands.append({"image": "c5.png", "target_mask": "cm5.png",
                  "icl_examples": [{"image": "c6.png", "mask": "cm6.png"}]})
    json.dump(cands, open(tmp / "cands.json", "w"))
    tests = [{"image": f"c{i}.png", "conversations": [
        {"from": "human", "value": "<image>\nSegment the lesion."},
        {"from": "gpt", "value": "It is <SEG> ."}]} for i in (2, 6)]
    json.dump(tests, open(tmp / "test.json", "w"))
    return str(tmp)


def test_encoder_embeddings_match_jax(encoders, corpus):
    je, te, _, _ = encoders
    paths = [os.path.join(corpus, f"c{i}.png") for i in range(7)]
    want = je.encode_paths(paths)
    got = te.encode_paths(paths)
    assert got.dtype == np.float32 and got.shape == want.shape
    close(got, want, **EMB_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert te.encode_paths([]).shape == je.encode_paths([]).shape


def test_build_and_augment_match_jax(encoders, corpus, tmp_path):
    je, te, _, _ = encoders
    cands = os.path.join(corpus, "cands.json")
    test_json = os.path.join(corpus, "test.json")
    out = {}
    for name, mod, enc in (("jax", jrag, je), ("port", trag, te)):
        idx = str(tmp_path / f"{name}_index")
        info = mod.build_index(cands, corpus, idx, enc)
        aug = str(tmp_path / f"{name}_aug.json")
        n = mod.augment(test_json, idx, aug, enc, top_k=2,
                        image_folder=corpus)
        out[name] = (idx, info, n, json.load(open(aug)))
    (jidx, jinfo, jn, jaug), (tidx, tinfo, tn, taug) = out["jax"], out["port"]
    assert tinfo == jinfo and jinfo["count"] == 7 and tn == jn == 2
    assert json.load(open(os.path.join(tidx, "metadata.json"))) == \
        json.load(open(os.path.join(jidx, "metadata.json")))
    close(np.load(os.path.join(tidx, "embeddings.npy")),
          np.load(os.path.join(jidx, "embeddings.npy")), **EMB_TOL)
    assert taug == jaug
    # each query retrieves itself first
    assert [a["icl_examples"][0]["image"] for a in taug] == \
        [os.path.join(corpus, f"c{i}.png") for i in (2, 6)]
    # an index of either package is read by the other
    for idx, mod, enc in ((jidx, trag, te), (tidx, jrag, je)):
        aug = str(tmp_path / "cross.json")
        mod.augment(test_json, idx, aug, enc, top_k=2, image_folder=corpus)
        assert json.load(open(aug)) == jaug


def test_candidate_extraction_matches_jax(tmp_path):
    recs = [
        {"image": "a.png", "target_mask": "tm.png", "mask": "m.png"},
        {"image": "b.png",
         "conversations": [{"value": "seg <mask>inline.png</mask>"}]},
        {"image2": "c2.png", "mask2": "cm2.png", "image10": "c10.png",
         "mask10": "cm10.png"},
        {"image": "d.png", "mask": "dm.png",
         "icl_examples": [{"image": "e.png", "mask": "em.png"},
                          {"image": "f.png"}]},
        {"image": "g.png", "mask3": "m3.png",
         "examples": [{"image": "h.png", "mask": "hm.png"}]},
        {"image": "nomask.png"},
    ]
    p = tmp_path / "cands.json"
    p.write_text(json.dumps(recs))
    assert trag.collect_candidates(str(p), "/imgs") == \
        jrag.collect_candidates(str(p), "/imgs")
    for r in recs:
        assert trag.extract_target_mask(r) == jrag.extract_target_mask(r)
        assert trag.extract_query_image(r) == jrag.extract_query_image(r)


def test_make_encoder_loads_each_type(encoders, corpus, tmp_path,
                                      monkeypatch):
    """Every registry type resolves its default path under the root and
    loads a save_params file; the embeddings equal the source tree's."""
    je, _, cfg, p = encoders
    assert trag.RAG_ENCODER_DEFAULT_PATHS == jrag.RAG_ENCODER_DEFAULT_PATHS
    monkeypatch.setenv("MEDPLIB_RAG_ENCODER_ROOT", str(tmp_path))
    want = je.encode_paths([os.path.join(corpus, "c1.png")])
    for t, sub in trag.RAG_ENCODER_DEFAULT_PATHS.items():
        save_params(str(tmp_path / sub), bridge(p))
        enc = trag.make_encoder(t, cfg=port_cfg(cfg), batch_size=2,
                                device="cpu")
        assert enc.encoder_type == t and enc.device == torch.device("cpu")
        close(enc.encode_paths([os.path.join(corpus, "c1.png")]), want,
              **EMB_TOL)
    with pytest.raises(ValueError, match="unknown RAG encoder type"):
        trag.make_encoder("bogus_encoder", device="cpu")


def test_main_build_and_augment_on_cpu(encoders, corpus, tmp_path, capsys,
                                       monkeypatch):
    """The two subcommands with --device cpu write what the library
    functions write; --device defaults to cuda."""
    je, _, cfg, p = encoders
    ap = trag.build_argparser()
    for argv in (["build", "--candidates", "c", "--out-dir", "o"],
                 ["augment", "--test-json", "t", "--index-dir", "i",
                  "--out-json", "o"]):
        assert ap.parse_args(argv).device == "cuda"
    ckpt = str(tmp_path / "clip.pt")
    save_params(ckpt, bridge(p))
    # main builds the encoder with the default (full-size) CLIP config:
    # give it the tiny one
    monkeypatch.setattr(trag, "ClipVisionConfig", lambda: port_cfg(cfg))
    idx = str(tmp_path / "index")
    trag.main(["build", "--candidates", os.path.join(corpus, "cands.json"),
               "--image-folder", corpus, "--out-dir", idx,
               "--clip-checkpoint", ckpt, "--device", "cpu"])
    assert "'count': 7" in capsys.readouterr().out
    aug = str(tmp_path / "aug.json")
    trag.main(["augment", "--test-json", os.path.join(corpus, "test.json"),
               "--index-dir", idx, "--out-json", aug, "--image-folder",
               corpus, "--top-k", "3", "--clip-checkpoint", ckpt,
               "--device", "cpu"])
    assert "augmented 2 records" in capsys.readouterr().out
    jidx = str(tmp_path / "jindex")
    jrag.build_index(os.path.join(corpus, "cands.json"), corpus, jidx, je)
    jaug = str(tmp_path / "jaug.json")
    jrag.augment(os.path.join(corpus, "test.json"), jidx, jaug, je, 3,
                 corpus)
    assert json.load(open(aug)) == json.load(open(jaug))


class FakeTok:
    bos_token_id, pad_token_id = 1, 0
    model_max_length = 512

    def __call__(self, text, add_special_tokens=True):
        import types
        ids = [1] if add_special_tokens else []
        for w in text.replace("</s>", " </s> ").split():
            ids.append(2 if w == "</s>" else 500 if w.startswith("<SEG>")
                       else 3 + zlib.crc32(w.encode()) % 300)
        return types.SimpleNamespace(input_ids=ids)


def test_rag_augment_feeds_icl_generate(encoders, corpus, tmp_path):
    """Index -> augment (two examples) -> ICL dataset -> collate_icl ->
    MoE generate: the port's tokens equal the JAX generate's (jax.jit)
    on the same batch and tree, masks within 1e-4."""
    _, te, _, _ = encoders
    idx = str(tmp_path / "index")
    trag.build_index(os.path.join(corpus, "cands.json"), corpus, idx, te)
    aug = str(tmp_path / "aug.json")
    trag.augment(os.path.join(corpus, "test.json"), idx, aug, te, top_k=2,
                 image_folder=corpus)
    recs = json.load(open(aug))
    assert all(len(r["icl_examples"]) == 2 for r in recs)

    cfg = dataclasses.replace(
        jc.MedplibConfig.tiny(), icl_enable=True,
        moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                         capacity_factor=4.0, eval_capacity_factor=4.0,
                         moe_mode="dense"))
    samples = {}
    for name, ds_mod, icl_mod in (("jax", jds, jicl), ("port", tds, ticl)):
        dcfg = ds_mod.DataConfig(data_path=aug, image_folder=corpus,
                                 sam_image_size=cfg.sam.image_size,
                                 clip_image_size=cfg.vision.image_size)
        ds = icl_mod.ICLLazySupervisedDataset(
            dcfg, FakeTok(), image_tokens=cfg.vision.num_patches)
        samples[name] = [ds[i] for i in range(2)]
    assert samples["port"][0]["image_clip"].shape[0] == 3  # 2 examples + q
    assert samples["port"][0]["image_token_types"] == ["image"] * 3
    cc = dict(max_seq_len=128, image_tokens=cfg.vision.num_patches,
              sam_image_size=cfg.sam.image_size,
              clip_image_size=cfg.vision.image_size)
    jarr, _ = jicl.collate_icl(samples["jax"], jds.CollatorConfig(**cc))
    tarr, _ = ticl.collate_icl(samples["port"], tds.CollatorConfig(**cc))
    for k in jarr:       # pixels: the port's resampler is within 1e-5
        if jarr[k].dtype.kind == "f":
            close(tarr[k], jarr[k], **EMB_TOL)
        else:
            np.testing.assert_array_equal(tarr[k], jarr[k], err_msg=k)
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    p["llm"]["embed_tokens"]["embedding"] = \
        p["llm"]["embed_tokens"]["embedding"] * 50.0
    p = snap(p)
    want = jax.jit(lambda pp, b: jm.generate(pp, cfg, b, max_new_tokens=3))(
        p, jds.to_model_batch(jarr))
    got = tm.generate(bridge(p), port_cfg(cfg),
                      tds.to_model_batch(jarr, "cpu"), max_new_tokens=3)
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    assert bool(torch.isfinite(got.pred_masks).all())
    close(got.pred_masks, want.pred_masks, rtol=1e-4, atol=1e-4)
