"""The port's export tools against the JAX package's, on the CPU:
config JSON (medplib_tpu_torch/config.py to_json / from_json, read across
the two packages), the safetensors reader and writer
(utils/_safetensors.py, held to the `safetensors` package), save_hf_dir,
utils/export.py's merge_lora, cast_f32, inspect_tree, make_delta /
apply_delta, consolidate, export_seg_decoder and every `main` subcommand,
and the QLoRA export route (dequantize_tree, then merge).

Inputs are JAX trees from a seed, snapshotted to numpy (the JAX
quantizers donate their input) and bridged leaf for leaf. Unless a test
says otherwise, results must be EQUAL (no tolerance): the same float32 /
bf16 arithmetic, one rounding each.
"""

import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import llama as jllama
from medplib_tpu.models import medplib as jm
from medplib_tpu.train import lora as jl
from medplib_tpu.utils import export as jexport
from medplib_tpu.utils import hf_export as jhx
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.train import lora as tlora
from medplib_tpu_torch.utils import _safetensors as tst
from medplib_tpu_torch.utils import checkpoint as tckpt
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import export as texport
from medplib_tpu_torch.utils import hf_export as thx
from medplib_tpu_torch.utils import quantize as tq
from medplib_tpu_torch.utils import tree as tree_util

torch.set_num_threads(1)


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def snap(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def jax_paths(tree):
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_same(got, want):
    """Torch tree vs JAX / numpy tree: the same key paths, shapes, dtypes
    (bf16 stays bf16) and equal values."""
    gl, wl = tree_util.leaves_with_paths(got), jax_paths(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        wt = convert.tree_from_numpy(w, "cpu")
        assert g.dtype == wt.dtype and g.shape == wt.shape, path
        assert torch.equal(g.cpu(), wt), path


def tiny_moe_cfg():
    return jc.MedplibConfig.tiny(moe=jc.MoeConfig(
        enable=True, num_experts=2, top_k=1, moe_mode="dense"))


def lora_llama(dtype, seed=1):
    """A tiny LLaMA with LoRA on q / v (transposed [out, in] kernels) and
    gate / up, lora_b random (as after training)."""
    cfg = jc.LlamaConfig.tiny()
    llm = jllama.init_llama(jax.random.PRNGKey(seed), cfg, dtype)
    llm = jl.inject(jax.random.PRNGKey(seed + 1), llm,
                    ("q_proj", "v_proj", "gate_proj", "up_proj"), r=4)
    rng = np.random.default_rng(seed)
    for _, node in jl._iter_linear_paths(llm):
        if "lora_b" in node:
            node["lora_b"] = jnp.asarray(rng.normal(
                size=node["lora_b"].shape).astype(np.float32) * 0.1
            ).astype(node["lora_b"].dtype)
    return snap(llm)


# ---------------------------------------------------------------------------
# config JSON
# ---------------------------------------------------------------------------

CONFIGS = {
    "LlamaConfig": lambda: jc.LlamaConfig(num_layers=3, rope_theta=5e5),
    "MoeConfig": lambda: jc.MoeConfig(enable=True, num_experts=4, top_k=2),
    "ClipVisionConfig": jc.ClipVisionConfig,
    "SamConfig": jc.SamConfig.tiny,
    "ProjectorConfig": lambda: jc.ProjectorConfig(region_adapter=True),
    "SegConfig": jc.SegConfig,
    "MedplibConfig": tiny_moe_cfg,
    "MedplibConfig_default": jc.MedplibConfig,
    "MeshConfig": lambda: jc.MeshConfig(data=2, expert=4, model=1),
    "TrainConfig": lambda: jc.TrainConfig(
        lora_target_modules=("q_proj", "k_proj", "v_proj")),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_json_across_packages(name):
    """JSON from the JAX package loads in the port to the equal config and
    back; the port writes the same text; unknown keys are dropped."""
    j = CONFIGS[name]()
    text = jc.to_json(j)
    t = tc.from_json(text)
    assert t == port_cfg(j)
    assert tc.to_json(t) == text
    assert jc.from_json(tc.to_json(t)) == j
    d = json.loads(text)
    d["no_such_field"] = 7
    assert tc.from_json(json.dumps(d)) == t


def test_mesh_config_total():
    m = tc.MeshConfig(data=2, expert=4, model=3)
    assert m.total == jc.MeshConfig(data=2, expert=4, model=3).total == 24


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def _st_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "w.f32": torch.randn(5, 3, generator=g),
        "w.bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
        "w.f16": torch.randn(7, generator=g).to(torch.float16),
        "w.f64": torch.randn(2, 2, generator=g).double(),
        "q.i8": torch.randint(-128, 128, (3, 5), generator=g,
                              dtype=torch.int8),
        "i.i32": torch.randint(-9, 9, (4,), generator=g, dtype=torch.int32),
        "i.i64": torch.randint(-9, 9, (2, 3), generator=g),
        "u.u8": torch.randint(0, 255, (3,), generator=g, dtype=torch.uint8),
        "m.bool": torch.rand(6, generator=g) > 0.5,
        "s.scalar": torch.tensor(3.5),
        "e.empty": torch.zeros(0, 3),
        "v.view": torch.randn(6, 4, generator=g).t()[1:3],
    }


def test_safetensors_writer_read_by_package(tmp_path):
    import safetensors.numpy as stn
    import safetensors.torch as stt
    from safetensors import safe_open
    ts = _st_tensors()
    path = str(tmp_path / "a.safetensors")
    tst.save_file(ts, path, metadata={"format": "pt", "n": 3})
    got_np = stn.load_file(path)
    got_pt = stt.load_file(path)
    assert sorted(got_pt) == sorted(ts)
    for k, v in ts.items():
        assert got_pt[k].dtype == v.dtype and torch.equal(got_pt[k], v), k
        if v.dtype != torch.bfloat16:
            np.testing.assert_array_equal(got_np[k], v.numpy(), err_msg=k)
    with safe_open(path, framework="np") as h:
        assert h.metadata() == {"format": "pt", "n": "3"}
    # the port's reader reads its own file back
    back = tst.load_file(path)
    for k, v in ts.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_safetensors_reader_reads_package_files(tmp_path):
    import safetensors.torch as stt
    ts = {k: v.contiguous() for k, v in _st_tensors().items()}
    path = str(tmp_path / "b.safetensors")
    stt.save_file(ts, path, metadata={"format": "pt"})
    got = tst.load_file(path)
    assert sorted(got) == sorted(ts)
    for k, v in ts.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    _, meta, _ = tst.read_header(path)
    assert meta == {"format": "pt"}


def test_safetensors_reader_rejects_a_short_entry(tmp_path):
    path = str(tmp_path / "c.safetensors")
    tst.save_file({"a": torch.ones(4)}, path)
    header, _, start = tst.read_header(path)
    header["a"]["shape"] = [5]
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + data)
    with pytest.raises(ValueError, match="need"):
        tst.load_file(path)


# ---------------------------------------------------------------------------
# save_hf_dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shard_bytes", [
    (jnp.float32, 4 * 1024 ** 3), (jnp.float32, 1 << 20),
    (jnp.bfloat16, 1 << 19)])
def test_save_hf_dir_matches_jax(tmp_path, dtype, shard_bytes):
    """The same shard files, index and config.json as the JAX package's
    save_hf_dir; each package's reader reads the other's directory back to
    the state dict (the port's reader without the `safetensors`
    package)."""
    import safetensors.numpy as stn
    cfg = tiny_moe_cfg()
    p = snap(jm.init_medplib(jax.random.PRNGKey(3), cfg, dtype))
    sd = jhx.medplib_to_hf(p, cfg)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    text = jc.to_json(cfg)
    jhx.save_hf_dir(sd, jdir, config_json=text, shard_bytes=shard_bytes)
    thx.save_hf_dir(thx.medplib_to_hf(convert.tree_from_numpy(p, "cpu"),
                                      port_cfg(cfg)),
                    tdir, config_json=text, shard_bytes=shard_bytes)
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == files
    n_shards = sum(f.endswith(".safetensors") for f in files)
    assert (n_shards > 1) == (shard_bytes < 1 << 30)
    for f in files:
        if f.endswith(".json"):
            with open(os.path.join(jdir, f)) as a, \
                    open(os.path.join(tdir, f)) as b:
                assert json.load(a) == json.load(b), f
        else:
            want = stn.load_file(os.path.join(jdir, f))
            got = tst.load_file(os.path.join(tdir, f))
            assert sorted(got) == sorted(want), f
            for k, v in want.items():
                np.testing.assert_array_equal(
                    convert.tree_to_numpy(got[k]),
                    np.asarray(v, np.float32) if v.dtype.name == "bfloat16"
                    else v, err_msg=k)
    back = texport.load_hf_torch_dir(jdir, "cpu")
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], convert.tree_from_numpy(v, "cpu")), k


# ---------------------------------------------------------------------------
# merge_lora, cast_f32, inspect_tree, deltas, consolidate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_merge_lora_matches_jax(dtype):
    host = lora_llama(dtype)
    want = jexport.merge_lora(jax.tree_util.tree_map(jnp.asarray, host))
    got = texport.merge_lora(convert.tree_from_numpy(host, "cpu"))
    assert_same(got, want)
    assert not any("lora_a" in p for p, _ in tree_util.leaves_with_paths(got))


def test_cast_f32_matches_jax():
    host = snap(jq.quantize_tree(
        jllama.init_llama(jax.random.PRNGKey(4), jc.LlamaConfig.tiny(),
                          jnp.bfloat16), bits=8))
    want = jexport.cast_f32(jax.tree_util.tree_map(jnp.asarray, host))
    got = texport.cast_f32(convert.tree_from_numpy(host, "cpu"))
    assert_same(got, want)
    assert {v.dtype for v in tree_util.leaves(got)} == {torch.float32,
                                                        torch.int8}


def test_inspect_tree_lines_match_jax():
    host = snap(jq.quantize_tree(
        jm.init_medplib(jax.random.PRNGKey(5), tiny_moe_cfg(),
                        jnp.bfloat16), bits=8))
    want, got = [], []
    n_j = jexport.inspect_tree(host, out=want.append)
    n_t = texport.inspect_tree(convert.tree_from_numpy(host, "cpu"),
                               out=got.append)
    assert got == want
    assert n_t == n_j == sum(int(np.prod(v.shape))
                             for v in jax.tree_util.tree_leaves(host))
    assert got[-1].startswith("TOTAL")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_make_and_apply_delta_match_jax(dtype):
    """Deltas in float32, cast back to the leaf's dtype (bit-equal to
    JAX); a target-only leaf and a resized leaf pass through; base +
    delta gives JAX's result."""
    rng = np.random.default_rng(6)

    def arr(*shape):
        return np.asarray(jnp.asarray(rng.normal(size=shape), dtype))

    base = {"llm": {"a": {"kernel": arr(8, 4)}, "emb": arr(10, 4)},
            "b": [arr(3), arr(2, 2)]}
    target = {"llm": {"a": {"kernel": arr(8, 4)}, "emb": arr(12, 4)},
              "b": [arr(3), arr(2, 2)], "mm_projector": {"kernel": arr(4)}}
    want = jexport.make_delta(base, target)
    got = texport.make_delta(convert.tree_from_numpy(base, "cpu"),
                             convert.tree_from_numpy(target, "cpu"))
    assert_same(got, want)
    want_back = jexport.apply_delta(base, want)
    got_back = texport.apply_delta(convert.tree_from_numpy(base, "cpu"), got)
    assert_same(got_back, want_back)


def test_consolidate_and_view_leaves(tmp_path):
    """consolidate writes a loadable copy; a tree of views (a layer of a
    stack) saves only the views' elements."""
    stack = torch.randn(16, 64, 64)
    tree = {"layers": {"kernel": stack[:2]}, "b": [torch.arange(3)]}
    src, dst = str(tmp_path / "src.pt"), str(tmp_path / "dst.pt")
    tckpt.save_params(src, tree)
    assert os.path.getsize(src) < stack.numel() * 4 // 4
    texport.consolidate(src, dst, device="cpu")
    out = tckpt.load_params(dst, device="cpu")
    assert torch.equal(out["layers"]["kernel"], stack[:2])
    assert torch.equal(out["b"][0], torch.arange(3))


# ---------------------------------------------------------------------------
# the exported SEG decoder
# ---------------------------------------------------------------------------

def test_export_seg_decoder_matches_jax_program():
    """The torch.export program, serialized and loaded back, against the
    JAX package's StableHLO export called through jax.export on the same
    params and inputs; 2e-5 absolute on the mask logits and iou (the same
    float32 decoder, summed in another order)."""
    cfg = jc.MedplibConfig.tiny()
    p = snap(jm.init_medplib(jax.random.PRNGKey(7), cfg))
    blob_j = jexport.export_seg_decoder(p, cfg, batch_size=2, num_segs=2,
                                        platforms=("cpu",))
    tp = convert.tree_from_numpy(p, "cpu")
    blob_t = texport.export_seg_decoder(tp, port_cfg(cfg), batch_size=2,
                                        num_segs=2)
    assert isinstance(blob_t, bytes)
    e, d = cfg.sam.image_embedding_size, cfg.sam.prompt_embed_dim
    rng = np.random.default_rng(8)
    emb = rng.normal(size=(2, e, e, d)).astype(np.float32)
    hid = rng.normal(size=(2, 2, cfg.llm.hidden_size)).astype(np.float32)
    from jax import export as jx
    wm, wi = jx.deserialize(blob_j).call(p["sam"], p["text_hidden_fcs"],
                                         jnp.asarray(emb), jnp.asarray(hid))
    prog = torch.export.load(io.BytesIO(blob_t)).module()
    gm, gi = prog(tp["sam"], tp["text_hidden_fcs"], torch.from_numpy(emb),
                  torch.from_numpy(hid))
    assert tuple(gm.shape) == (2, 2, cfg.sam.image_size, cfg.sam.image_size)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=2e-5)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=2e-5)
    # and the program equals a direct call of the port's functions
    seg = tm.text_hidden_fcs(tp["text_hidden_fcs"], torch.from_numpy(hid))
    dm, di = tm.decode_seg_masks(tp, port_cfg(cfg), torch.from_numpy(emb),
                                 seg, cfg.sam.image_size)
    assert torch.equal(gm, dm) and torch.equal(gi, di)


# ---------------------------------------------------------------------------
# the QLoRA export route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["int8", "int4h", "int4_block"])
def test_qlora_export_route_matches_jax(scheme):
    """A quantized LLaMA with LoRA on q / v: dequantize_tree (bf16), then
    merge, equal to the JAX package's leaf for leaf."""
    bits, kw = {"int8": (8, {}), "int4h": (4, {}),
                "int4_block": (4, dict(int4_scheme="block", block=32))}[scheme]
    cfg = jc.LlamaConfig.tiny()
    llm = jq.quantize_tree(jllama.init_llama(jax.random.PRNGKey(9), cfg,
                                             jnp.bfloat16), bits=bits, **kw)
    llm = jl.inject(jax.random.PRNGKey(10), llm, ("q_proj", "v_proj"), r=4)
    rng = np.random.default_rng(11)
    for _, node in jl._iter_linear_paths(llm):
        if "lora_b" in node:
            node["lora_b"] = jnp.asarray(rng.normal(
                size=node["lora_b"].shape), jnp.bfloat16)
    host = snap(llm)
    want = jl.merge(jq.dequantize_tree(
        jax.tree_util.tree_map(jnp.asarray, host), jnp.bfloat16))
    got = tlora.merge(tq.dequantize_tree(convert.tree_from_numpy(host, "cpu"),
                                      torch.bfloat16))
    assert_same(got, want)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_main_subcommands(tmp_path, capsys):
    """merge-lora, to-f32 and inspect on a saved tiny tree; to-hf (sharded)
    and from-reference back, each against the JAX functions on the same
    tree."""
    P = lambda n: str(tmp_path / n)  # noqa: E731
    run = lambda *a: texport.main(["--device", "cpu", *a])  # noqa: E731

    host = lora_llama(jnp.bfloat16)
    tckpt.save_params(P("lora.pt"), convert.tree_from_numpy(host, "cpu"))
    run("merge-lora", "--in-path", P("lora.pt"), "--out-path", P("m.pt"))
    merged = jexport.merge_lora(jax.tree_util.tree_map(jnp.asarray, host))
    assert_same(tckpt.load_params(P("m.pt"), device="cpu"), merged)

    run("to-f32", "--in-path", P("m.pt"), "--out-path", P("f.pt"))
    assert_same(tckpt.load_params(P("f.pt"), device="cpu"),
                jexport.cast_f32(merged))

    capsys.readouterr()
    run("inspect", "--in-path", P("m.pt"))
    lines = capsys.readouterr().out.splitlines()
    want = []
    jexport.inspect_tree(snap(merged), out=want.append)
    assert lines == want

    cfg = tiny_moe_cfg()
    p = snap(jm.init_medplib(jax.random.PRNGKey(12), cfg, jnp.bfloat16))
    tckpt.save_params(P("full.pt"), convert.tree_from_numpy(p, "cpu"))
    with open(P("cfg.json"), "w") as f:
        f.write(tc.to_json(port_cfg(cfg)))
    run("to-hf", "--in-path", P("full.pt"), "--config", P("cfg.json"),
        "--out-dir", P("hf"), "--shard-bytes", str(1 << 19))
    assert os.path.exists(os.path.join(P("hf"),
                                       "model.safetensors.index.json"))
    sd_want = jhx.medplib_to_hf(p, cfg)
    sd_got = jexport.load_hf_torch_dir(P("hf"))     # the JAX reader
    assert sorted(sd_got) == sorted(sd_want)
    for k, v in sd_want.items():
        np.testing.assert_array_equal(np.asarray(sd_got[k], np.float32),
                                      np.asarray(v, np.float32), err_msg=k)
    with open(os.path.join(P("hf"), "config.json")) as f:
        assert jc.from_json(f.read()) == cfg

    run("from-reference", "--hf-dir", P("hf"), "--config", P("cfg.json"),
        "--out-path", P("back.pt"))
    back = tckpt.load_params(P("back.pt"), device="cpu")
    _, direct = texport.load_reference_checkpoint(P("hf"), cfg=port_cfg(cfg),
                                                  device="cpu")
    gl, dl = (tree_util.leaves_with_paths(back),
              tree_util.leaves_with_paths(direct))
    assert [q for q, _ in gl] == [q for q, _ in dl]
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for (_, a), (_, b) in zip(gl, dl))
    # against JAX: the same paths and values (the zero dense-MLP
    # placeholder of an all-MoE stack is bf16 in the port, f32 in JAX)
    _, want_tree = jexport.load_reference_checkpoint(P("hf"), cfg=cfg)
    wl = jax_paths(want_tree)
    assert [q for q, _ in gl] == [q for q, _ in wl]
    for (q, a), (_, w) in zip(gl, wl):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w, np.float32), err_msg=q)
    with open(P("back.pt") + ".config.json") as f:
        assert jc.from_json(f.read()) == cfg


# ---------------------------------------------------------------------------
# the merge, held on a bf16 tree (chip_smoke's export-path checks)
# ---------------------------------------------------------------------------

def test_merge_holds_bf16_stage4_tree():
    """A tiny bf16 stage-4 tree (every layer MoE, LoRA q / v with lora_b
    at a few Adam steps' size): every merged q / v element within bf16
    rounding of W + AB x 2 in f32 (chip_smoke.merge_kernel_hold <= 1),
    and the teacher-forced logits within chip_smoke's MERGE_REL_TOL /
    MERGE_MIN_AGREE (scripts/merge_hold_cpu.py measures them at 32
    layers)."""
    import chip_smoke as cs
    from medplib_tpu_torch.ops.initializers import normal
    cfg = dataclasses.replace(cs.tiny_serving_cfg(128, 2), moe=tc.MoeConfig(
        enable=True, num_experts=2, top_k=1, capacity_factor=1.5,
        eval_capacity_factor=2.0, moe_mode="dense"))
    gen = torch.Generator().manual_seed(0)
    p = cs.init_stage4(cfg, gen, "cpu")
    p["llm"] = tlora.inject(gen, p["llm"], ("q_proj", "v_proj"), r=8)
    for n in ("q_proj", "v_proj"):
        node = p["llm"]["layers"]["attn"][n]
        node["lora_b"] = normal(gen, node["lora_b"].shape,
                                node["lora_b"].dtype, "cpu", 3e-4)
    m = texport.merge_lora(p)
    assert cs.merge_kernel_hold(p, m) <= 1.0
    batch = cs.make_batch(cfg, 2, 64, np.random.default_rng(0), "cpu")
    rel, agree = cs.merge_hold(p, m, cfg, batch)
    assert rel <= cs.MERGE_REL_TOL and agree >= cs.MERGE_MIN_AGREE, \
        (rel, agree)
