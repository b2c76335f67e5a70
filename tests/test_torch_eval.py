"""The port's evaluation modules (medplib_tpu_torch/eval: vqa_metrics,
infer, cli, gate_analysis) held to the JAX package's on the CPU.

- vqa_metrics: equal outputs on the same strings and records (the port's
  BLEU is its own copy of nltk's sentence_bleu, held equal to the JAX
  module, which calls nltk).
- infer: get_chunk and truncate_prompt_at_colon equal; the JAX Evaluator
  (jax.jit of generate) and the port's on one on-disk dataset and one
  tree, in seg, vqa and ICL mode: equal jsonl texts and fields, IoU /
  Dice within 1e-3 (mask logits of f32 models that follow the compiled
  reference), metrics within 0.1 (they are in %).
- cli: the JAX CLI's flags and defaults plus --device; both CLIs at
  --tiny --precision fp32 on the same tree (saved once in each package's
  checkpoint format), plain and ICL: equal answers, metrics within 0.1.
- gate_analysis: capture_router_logits on a tiny MoE model within 1e-4
  of the JAX function, is_image and attn_mask equal; expert_load on JAX's
  logits equal to JAX's; plot_expert_load writes a PNG.

Models: MedplibConfig.tiny / tiny_cli_config (f32) with embeddings x 50,
so greedy choices are not near ties (tests/test_torch_serve.py). The
tokenizers are offline stubs; every port call runs on the CPU.
"""

import dataclasses
import json
import os
import warnings
import zlib
from functools import partial

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import medplib_tpu.config as jc
from medplib_tpu.data import dataset as jds
from medplib_tpu.data import icl_dataset as jicl
from medplib_tpu.eval import cli as jcli
from medplib_tpu.eval import gate_analysis as jga
from medplib_tpu.eval import infer as jinf
from medplib_tpu.eval import vqa_metrics as jvm
from medplib_tpu.models import medplib as jm
from medplib_tpu_torch.data import dataset as tds
from medplib_tpu_torch.data import icl_dataset as ticl
from medplib_tpu_torch.eval import cli as tcli
from medplib_tpu_torch.eval import gate_analysis as tga
from medplib_tpu_torch.eval import infer as tinf
from medplib_tpu_torch.eval import vqa_metrics as tvm
from test_cli import FakeHFTok, fake_tokenizer  # noqa: F401 - fixture
from test_torch_modules import bridge, port_cfg, snap

torch.set_num_threads(1)
COLON = 400
IOU_TOL = 1e-3       # per-sample IoU / Dice
METRIC_TOL = 0.1     # the same in % (evaluate_seg)


# ---------------------------------------------------------------------------
# VQA metrics
# ---------------------------------------------------------------------------

PAIRS = [
    ("The left lung.", "left lung"), ("two", "2"), ("yes", "Yes"),
    ("an MRI scan, of the brain", "brain MRI"), ("", "nothing"),
    ("it's the liver", "its liver"), ("1,000 cells", "1000 cells"),
    ("a b c d e f", "a b c d e g"), ("lesion lesion lesion", "lesion"),
    ("(right) kidney?", "right kidney"), ("x-ray / ct", "ct x ray"),
    ("none", "zero"), ("dont", "don't"), ("3.5 cm", "3.5cm"),
]
WORDS = ["the", "a", "left", "right", "lung", "two", "2", "none", "yes",
         "no", ",", ".", "?", "dont", "it's", "1,000", "x-ray", "(ct)",
         "mass", "lesion"]


@pytest.mark.parametrize("cand,ref", PAIRS)
def test_vqa_word_metrics_match_jax(cand, ref):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # nltk's zero-overlap warning
        want_bleu = jvm.bleu_scores(cand, ref)
    assert tvm.normalize_word(cand) == jvm.normalize_word(cand)
    for n in (1, 2, 3):
        assert tvm.split_sentence(cand, n) == jvm.split_sentence(cand, n)
    assert tvm.calculate_exactmatch(cand, ref) == \
        jvm.calculate_exactmatch(cand, ref)
    assert tvm.calculate_f1score(cand, ref) == \
        jvm.calculate_f1score(cand, ref)
    assert tvm.calculate_appearance_with_normalization(
        cand, ref, [ref, "x", cand]) == \
        jvm.calculate_appearance_with_normalization(cand, ref,
                                                    [ref, "x", cand])
    assert tvm.bleu_scores(cand, ref) == want_bleu


@settings(max_examples=80, deadline=None)
@given(st.lists(st.sampled_from(WORDS), max_size=9),
       st.lists(st.sampled_from(WORDS), max_size=9))
def test_vqa_metrics_match_jax_random_words(cw, rw):
    cand, ref = " ".join(cw), " ".join(rw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jvm.bleu_scores(cand, ref)
    assert tvm.bleu_scores(cand, ref) == want
    assert tvm.calculate_f1score(cand, ref) == \
        jvm.calculate_f1score(cand, ref)
    assert tvm.normalize_word(cand) == jvm.normalize_word(cand)


def test_evaluate_vqa_matches_jax():
    types = ["open", "closed", "yes/no", "number", "other", "OPEN"]
    recs = [{"text": c, "gt": r, "answer_type": types[i % len(types)],
             "modality": ["ct", "mr"][i % 2]}
            for i, (c, r) in enumerate(PAIRS)]
    for kw in ({}, {"candidate_set": ["left lung", "brain MRI", "2"]},
               {"by_modality_key": "modality"}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jvm.evaluate_vqa(recs, **kw)
        assert tvm.evaluate_vqa(recs, **kw) == want
    assert tvm.evaluate_vqa([]) == jvm.evaluate_vqa([])


# ---------------------------------------------------------------------------
# chunking and truncation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunks", [(10, 3), (10, 20), (3, 5), (7, 7),
                                      (5, 1)])
def test_get_chunk_matches_jax(n, chunks):
    items = list(range(n))
    got = [tinf.get_chunk(items, chunks, i) for i in range(chunks)]
    assert got == [jinf.get_chunk(items, chunks, i) for i in range(chunks)]
    assert sum(got, []) == items


def test_get_chunk_of_nothing_raises_as_jax():
    for mod in (jinf, tinf):
        with pytest.raises(ValueError):
            mod.get_chunk([], 2, 0)


@pytest.mark.parametrize("ids", [[1, 5, 400, 7, 8], [1, 2], [400],
                                 [1, 400, 3, 400, 9], []])
def test_truncate_prompt_at_colon_matches_jax(ids):
    a = np.array(ids, np.int64)
    assert tinf.truncate_prompt_at_colon(a, COLON).tolist() == \
        jinf.truncate_prompt_at_colon(a, COLON).tolist()


def test_eval_config_defaults_match_jax():
    assert dataclasses.asdict(tinf.EvalConfig()) == \
        dataclasses.asdict(jinf.EvalConfig())


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class Tok:
    """Word-level stub: ':' -> 400 (the colon id), '<SEG>' -> 500 (the
    tiny model's SEG id), '</s>' -> EOS, other words from their crc32."""

    bos_token_id, pad_token_id, eos_token_id = 1, 0, 2
    model_max_length = 512

    def __call__(self, text, add_special_tokens=True):
        import types
        ids = [1] if add_special_tokens else []
        for w in text.replace("</s>", " </s> ").split():
            ids.append({":": COLON, "<SEG>": 500, "</s>": 2}.get(
                w, 3 + zlib.crc32(w.encode()) % 300))
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"t{int(t)}" for t in ids)


@pytest.fixture(scope="module")
def evalset(tmp_path_factory):
    """Five seeded 50 x 70 images with masks; seg questions, open and
    closed answers; and ICL records whose icl_examples name two of them."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("evalset")
    rng = np.random.default_rng(0)
    records, icl = [], []
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (50, 70, 3)).astype(
            np.uint8)).save(tmp / f"ct_img{i}.png")
        m = np.zeros((50, 70), np.uint8)
        m[5 + 3 * i:30, 10 + 2 * i:45] = 255
        Image.fromarray(m).save(tmp / f"m{i}.png")
        records.append({
            "image": f"ct_img{i}.png",
            "answer_type": ["open", "closed"][i % 2],
            "conversations": [
                {"from": "human", "value": "<image>\nsegment the organ :"},
                {"from": "gpt",
                 "value": f"it is <SEG> <mask>m{i}.png</mask>"}]})
        icl.append({"image": f"ct_img{i}.png", "target_mask": f"m{i}.png",
                    "icl_examples": [
                        {"image": f"ct_img{(i + k) % 5}.png",
                         "mask": f"m{(i + k) % 5}.png"} for k in (1, 2)]})
    json.dump(records, open(tmp / "test.json", "w"))
    json.dump(icl, open(tmp / "icl.json", "w"))
    return str(tmp)


def _tiny_tree(cfg, key=0):
    p = jm.init_medplib(jax.random.PRNGKey(key), cfg)
    p["llm"]["embed_tokens"]["embedding"] = \
        p["llm"]["embed_tokens"]["embedding"] * 50.0
    return snap(p)


def _lines(path):
    return [json.loads(line) for line in open(path)]


def _same_answers(got_path, want_path):
    got, want = _lines(got_path), _lines(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ("iou", "dice"):
                assert abs(g[k] - w[k]) <= IOU_TOL, (k, g[k], w[k])
            else:
                assert g[k] == w[k], (k, g[k], w[k])
    return got


def _same_metrics(got, want, tol=METRIC_TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same_metrics(got[k], want[k], tol)
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (got, want)
    else:
        assert got == want


def _run_both(cfg, tree, mode, out_dir, make_ds, collate_pair=(None, None),
              batch_size=2):
    """The JAX Evaluator and the port's on one dataset file and tree."""
    kw = dict(batch_size=batch_size, max_new_tokens=4, colon_token_id=COLON)
    cc = dict(max_seq_len=64, image_tokens=cfg.vision.num_patches,
              sam_image_size=cfg.sam.image_size,
              clip_image_size=cfg.vision.image_size)
    jout, tout = (os.path.join(out_dir, f"{s}_{mode}.jsonl")
                  for s in ("jax", "port"))
    want = jinf.Evaluator(cfg, tree, Tok(), jinf.EvalConfig(
        output_path=jout, **kw), jds.CollatorConfig(**cc),
        collate_fn=collate_pair[0]).run(make_ds(jds, jicl), mode)
    got = tinf.Evaluator(port_cfg(cfg), bridge(tree), Tok(), tinf.EvalConfig(
        output_path=tout, **kw), tds.CollatorConfig(**cc),
        collate_fn=collate_pair[1], device="cpu").run(make_ds(tds, ticl),
                                                      mode)
    return got, want, _same_answers(tout, jout)


def _plain_ds(folder, cfg):
    def make(ds_mod, _icl_mod):
        return ds_mod.LazySupervisedDataset(ds_mod.DataConfig(
            data_path=os.path.join(folder, "test.json"), image_folder=folder,
            sam_image_size=cfg.sam.image_size,
            clip_image_size=cfg.vision.image_size, augment_regions=False),
            Tok(), train=False)
    return make


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = jc.MedplibConfig.tiny()
    return cfg, _tiny_tree(cfg)


@pytest.mark.parametrize("mode", ["seg", "vqa"])
def test_evaluator_matches_jax(evalset, tiny_tree, tmp_path, mode):
    """Five samples at batch 2 (the last batch padded), greedy 4 tokens;
    seg: IoU / Dice per sample and the per-modality table; vqa: the VQA
    table on equal texts."""
    cfg, tree = tiny_tree
    got, want, rows = _run_both(cfg, tree, mode, str(tmp_path),
                                _plain_ds(evalset, cfg))
    assert [r["question_id"] for r in rows] == list(range(5))
    if mode == "seg":
        assert all("iou" in r for r in rows) and want["n"] == 5
        _same_metrics(got, want)
    else:
        assert got == want and want["num_open"] + want["num_closed"] == 5


def test_evaluator_icl_matches_jax(evalset, tmp_path):
    """ICL seg evaluation with collate_icl: two retrieved examples a
    record, separate masks through the mask encoder, the token
    compressor (the eval CLI's --icl-enable branch)."""
    cfg = jc.with_icl(jc.MedplibConfig.tiny(), token_compress=True,
                      mask_encoder=True)
    tree = _tiny_tree(cfg, key=3)
    max_slots = cfg.max_icl_examples * 2 + 1

    def make(ds_mod, icl_mod):
        return icl_mod.ICLLazySupervisedDataset(
            ds_mod.DataConfig(
                data_path=os.path.join(evalset, "icl.json"),
                image_folder=evalset, sam_image_size=cfg.sam.image_size,
                clip_image_size=cfg.vision.image_size,
                augment_regions=False),
            Tok(), train=False, mask_mode="separate", use_mask_encoder=True,
            image_tokens=jm.image_tokens_per_image(cfg),
            mask_tokens=cfg.projector.mask_encoder_tokens,
            max_examples=cfg.max_icl_examples,
            mask_input_size=cfg.projector.mask_input_size)

    pair = tuple(partial(mod.collate_icl, max_slots=max_slots,
                         mask_tokens=cfg.projector.mask_encoder_tokens)
                 for mod in (jicl, ticl))
    got, want, rows = _run_both(cfg, tree, "seg", str(tmp_path), make, pair,
                                batch_size=3)
    assert len(rows) == 5 and all("iou" in r for r in rows)
    _same_metrics(got, want)


def test_evaluator_chunks_merge_and_vis(evalset, tiny_tree, tmp_path):
    """Two chunks cover the set once; merge_chunk_outputs concatenates
    them; vis_dir writes one overlay panel per sample."""
    cfg, tree = tiny_tree
    ds = _plain_ds(evalset, cfg)(tds, ticl)
    cc = tds.CollatorConfig(max_seq_len=64,
                            image_tokens=cfg.vision.num_patches,
                            sam_image_size=cfg.sam.image_size,
                            clip_image_size=cfg.vision.image_size)
    outs, ns = [], 0
    for c in range(2):
        out = str(tmp_path / f"c{c}.jsonl")
        m = tinf.Evaluator(
            port_cfg(cfg), bridge(tree), Tok(), tinf.EvalConfig(
                num_chunks=2, chunk_idx=c, batch_size=2, max_new_tokens=2,
                colon_token_id=COLON, output_path=out,
                vis_dir=str(tmp_path / "vis")), cc,
            device="cpu").run(ds, "seg")
        outs.append(out)
        ns += m["n"]
    assert ns == 5
    merged = str(tmp_path / "all.jsonl")
    tinf.merge_chunk_outputs(outs, merged)
    assert [r["question_id"] for r in _lines(merged)] == list(range(5))
    assert sorted(os.listdir(tmp_path / "vis")) == \
        [f"{i}_overlay.png" for i in range(5)]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_eval_argparser_matches_jax():
    req = ["--version", "v", "--tokenizer", "t", "--dataset-json", "d",
           "--image-folder", "f"]
    want = vars(jcli.build_argparser().parse_args(req))
    got = vars(tcli.build_argparser().parse_args(req))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.fixture()
def cli_set(evalset, tmp_path):
    """evalset's records with FakeHFTok's SEG word ("<SEG>" after the
    stub's special tokens) in the test_cli form."""
    recs = json.load(open(os.path.join(evalset, "test.json")))
    for r in recs:
        r["conversations"][0]["value"] = "<image>\nSegment the lesion."
    path = tmp_path / "cli.json"
    json.dump(recs[:3], open(path, "w"))
    return str(path)


@pytest.mark.parametrize("icl", [False, True])
def test_eval_cli_matches_jax(fake_tokenizer, evalset, cli_set,  # noqa: F811
                              tmp_path, icl):
    """Both CLIs at --tiny --precision fp32 on one tree (PRNGKey(0),
    embeddings x 50), saved once with the JAX package's save_params
    (orbax) and once with the port's (torch.save): equal answers files,
    metrics within 0.1. icl: the --icl-enable overlay branch on records
    with icl_examples."""
    from medplib_tpu.data import tokenize as jtk
    from medplib_tpu.utils.checkpoint import save_params as jsave
    from medplib_tpu_torch.utils.checkpoint import save_params as tsave

    tok = FakeHFTok()
    jtk.add_special_tokens(tok)
    moe = jc.MoeConfig(enable=False, num_experts=2, top_k=1,
                       capacity_factor=1.5, eval_capacity_factor=2.0,
                       moe_mode="dense")
    cfg = jc.tiny_cli_config(moe, tok.convert_tokens_to_ids("<SEG>"),
                             len(tok))
    data = os.path.join(evalset, "icl.json") if icl else cli_set
    extra = ["--icl-enable"] if icl else []
    if icl:
        cfg = jc.with_icl(cfg)
    tree = _tiny_tree(cfg)
    jdir, tfile = str(tmp_path / "jax_ckpt"), str(tmp_path / "port.pt")
    jsave(jdir, tree)
    tsave(tfile, bridge(tree))
    res = {}
    for name, main, ver, dev in (("jax", jcli.main, jdir, []),
                                 ("port", tcli.main, tfile,
                                  ["--device", "cpu"])):
        ans = str(tmp_path / f"{name}.jsonl")
        met = str(tmp_path / f"{name}.json")
        main(["--version", ver, "--tokenizer", "fake", "--tiny",
              "--dataset-json", data, "--image-folder", evalset,
              "--mode", "seg", "--batch-size", "2", "--max-new-tokens", "4",
              "--model-max-length", "96", "--precision", "fp32",
              "--answers-file", ans, "--metrics-file", met] + extra + dev)
        res[name] = (ans, json.load(open(met)))
    rows = _same_answers(res["port"][0], res["jax"][0])
    assert len(rows) == (5 if icl else 3)
    _same_metrics(res["port"][1], res["jax"][1])


def test_eval_cli_random_runs_on_cpu(fake_tokenizer, evalset,  # noqa: F811
                                     cli_set, tmp_path):
    """--version random is the port's seeded init; bf16 by default."""
    ans = str(tmp_path / "a.jsonl")
    m = tcli.main(["--version", "random", "--tokenizer", "fake", "--tiny",
                   "--dataset-json", cli_set, "--image-folder", evalset,
                   "--mode", "vqa", "--batch-size", "2",
                   "--max-new-tokens", "2", "--answers-file", ans,
                   "--device", "cpu"])
    assert m["num_open"] + m["num_closed"] == 3
    assert len(_lines(ans)) == 3


# ---------------------------------------------------------------------------
# gate analysis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_capture(evalset):
    cfg = jc.MedplibConfig.tiny(moe=jc.MoeConfig(
        enable=True, num_experts=4, top_k=1, capacity_factor=1.5,
        eval_capacity_factor=2.0))
    tree = _tiny_tree(cfg, key=5)
    ds = _plain_ds(evalset, cfg)(jds, jicl)
    cc = jds.CollatorConfig(max_seq_len=64,
                            image_tokens=cfg.vision.num_patches,
                            sam_image_size=cfg.sam.image_size,
                            clip_image_size=cfg.vision.image_size)
    arrays, _ = jds.collate([ds[i] for i in range(4)], cc)
    want = jga.capture_router_logits(tree, cfg, jds.to_model_batch(arrays))
    got = tga.capture_router_logits(bridge(tree), port_cfg(cfg),
                                    tds.to_model_batch(arrays, "cpu"))
    return got, want


def test_capture_router_logits_matches_jax(moe_capture):
    got, want = moe_capture
    assert set(got) == set(want)
    assert got["router_logits"].shape == want["router_logits"].shape
    assert got["router_logits"].dtype == np.float32
    np.testing.assert_allclose(got["router_logits"], want["router_logits"],
                               rtol=1e-4, atol=1e-4)
    for k in ("is_image", "attn_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["is_image"].any() and (~got["is_image"]).any()


def test_expert_load_matches_jax(moe_capture, tmp_path):
    got, want = moe_capture
    load = tga.expert_load(want)
    ref = jga.expert_load(want)
    for kind in ("text", "image"):
        np.testing.assert_array_equal(load[kind], ref[kind])
        np.testing.assert_allclose(load[kind].sum(-1), 1.0)
    png = str(tmp_path / "load.png")
    tga.plot_expert_load(tga.expert_load(got), png)
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
