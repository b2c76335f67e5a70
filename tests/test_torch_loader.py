"""The released-checkpoint loader of medplib_tpu_torch (utils/hf_weights,
utils/export) and its inverse (utils/hf_export) against the JAX package's,
on the CPU.

State dicts in the released layouts are built from random JAX trees with
the JAX package's inverse translators (medplib_tpu/utils/hf_export.py);
the port's loader must give the JAX loader's tree leaf for leaf, with the
same key paths and shapes and EQUAL values after widening to float32 (no
tolerance), and keep each state dict's dtype (bf16 stays bf16). Covered:
LLaMA; MoE with every layer MoE and with a sparse stack, with and without
the Residual-MoE keys; SAM-Med2D; CLIP from a transformers
CLIPVisionModel state dict; the full merged checkpoint through
load_reference_checkpoint, from memory, from a directory of torch.save
shards and from safetensors shards. The port's medplib_to_hf must equal
JAX's key for key and value for value.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import llama as jllama
from medplib_tpu.models import medplib as jm
from medplib_tpu.models import moe_llama as jmoe
from medplib_tpu.models import sam_med2d as jsam
from medplib_tpu.utils import export as jexport
from medplib_tpu.utils import hf_export as jhx
from medplib_tpu.utils import hf_weights as jhw
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import export as texport
from medplib_tpu_torch.utils import hf_export as thx
from medplib_tpu_torch.utils import hf_weights as thw

torch.set_num_threads(1)


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def _flat(tree):
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_tree_equal(got, want, dtype=None):
    """Same key paths and shapes, equal values after widening; every port
    leaf a contiguous tensor of `dtype` (when given)."""
    g = _flat(jax.tree_util.tree_map(lambda x: x, got))
    w = _flat(want)
    assert sorted(g) == sorted(w), (sorted(set(g) ^ set(w)))[:6]
    for k, v in g.items():
        assert isinstance(v, torch.Tensor) and v.is_contiguous(), k
        if dtype is not None and v.is_floating_point():
            assert v.dtype == dtype, (k, v.dtype)
        wv = np.asarray(w[k])
        assert tuple(v.shape) == wv.shape, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      wv.astype(np.float32), err_msg=str(k))


def to_torch_sd(sd):
    return {k: thw.to_torch(v) for k, v in sd.items()}


def snap(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# translators, one family at a time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_llama_from_hf(dtype):
    cfg = jc.LlamaConfig.tiny()
    p = snap(jllama.init_llama(jax.random.PRNGKey(0), cfg, dtype))
    sd = jhx.llama_to_hf(p, cfg)
    got = thw.llama_from_hf(to_torch_sd(sd), port_cfg(cfg))
    assert_tree_equal(got, jhw.llama_from_hf(sd, cfg),
                      torch.bfloat16 if dtype == jnp.bfloat16
                      else torch.float32)


MOE_CASES = {
    "dense_moe": dict(moe_mode="dense"),
    "sparse_moe": dict(moe_mode="sparse"),
    "residual_dense": dict(moe_mode="dense", use_residual=True),
    "residual_sparse": dict(moe_mode="sparse", use_residual=True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_llama_from_hf(case):
    cfg = dataclasses.replace(jc.LlamaConfig.tiny(), num_layers=3)
    mc = jc.MoeConfig(enable=True, num_experts=2, **MOE_CASES[case])
    p = snap(jmoe.init_moe_llama(jax.random.PRNGKey(1), cfg, mc))
    idx = mc.layer_indices(cfg.num_layers)
    sd = jhx.moe_llama_to_hf(p, cfg, idx, 2)
    assert any(".mlp.mlp." in k for k in sd) == mc.use_residual
    got = thw.moe_llama_from_hf(to_torch_sd(sd), port_cfg(cfg), idx, 2)
    assert_tree_equal(got, jhw.moe_llama_from_hf(sd, cfg, idx, 2),
                      torch.float32)
    # and the port's own inverse gives back the same state dict
    back = thx.moe_llama_to_hf(got, port_cfg(cfg), idx, 2)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_sam_from_torch():
    cfg = jc.SamConfig.tiny()
    p = snap(jsam.init_sam(jax.random.PRNGKey(2), cfg))
    sd = jhx.sam_to_torch(p, cfg)
    want = jhw.sam_from_torch(sd, cfg)
    assert_tree_equal(thw.sam_from_torch(to_torch_sd(sd), port_cfg(cfg)),
                      want, torch.float32)
    # the released .pth nests everything under "model"
    assert_tree_equal(thw.sam_from_torch({"model": to_torch_sd(sd)},
                                         port_cfg(cfg)), want)
    back = thx.sam_to_torch(thw.sam_from_torch(to_torch_sd(sd),
                                               port_cfg(cfg)), port_cfg(cfg))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_clip_vision_from_hf():
    transformers = pytest.importorskip("transformers")
    cfg = jc.ClipVisionConfig.tiny()
    hf_cfg = transformers.CLIPVisionConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        hidden_act="quick_gelu", layer_norm_eps=cfg.layer_norm_eps)
    torch.manual_seed(0)
    sd = transformers.CLIPVisionModel(hf_cfg).eval().state_dict()
    want = jhw.clip_vision_from_hf(sd, cfg)
    got = thw.clip_vision_from_hf(sd, port_cfg(cfg))
    assert_tree_equal(got, want, torch.float32)
    half = {k: v.bfloat16() for k, v in sd.items()}
    got16 = thw.clip_vision_from_hf(half, port_cfg(cfg))
    assert_tree_equal(got16, jhw.clip_vision_from_hf(half, cfg),
                      torch.bfloat16)


def test_cast_tree():
    tree = {"a": torch.ones(2), "q": torch.ones(2, dtype=torch.int8),
            "l": [torch.zeros(3, dtype=torch.bfloat16)], "n": None}
    out = thw.cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["q"].dtype == torch.int8
    assert out["l"][0].dtype == torch.bfloat16 and out["n"] is None
    assert thw.cast_tree(out, torch.float32)["l"][0].dtype == torch.float32


# ---------------------------------------------------------------------------
# the full merged checkpoint
# ---------------------------------------------------------------------------

def _medplib(moe: bool, dtype=jnp.float32):
    over = dict(moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                                 moe_mode="dense")) if moe else {}
    cfg = jc.MedplibConfig.tiny(**over)
    return cfg, snap(jm.init_medplib(jax.random.PRNGKey(3), cfg, dtype))


def _jax_loaded(sd, cfg):
    _, params = jexport.load_reference_checkpoint(None, cfg=cfg,
                                                  state_dict=sd)
    return params


@pytest.mark.parametrize("moe", [True, False])
def test_medplib_to_hf_matches_jax(moe):
    cfg, p = _medplib(moe)
    want = jhx.medplib_to_hf(p, cfg)
    got = thx.medplib_to_hf(convert.tree_from_numpy(p, "cpu"), port_cfg(cfg))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_load_reference_checkpoint_from_memory(dtype):
    cfg, p = _medplib(True, dtype)
    sd = jhx.medplib_to_hf(p, cfg)
    want = _jax_loaded(sd, cfg)
    pcfg, got = texport.load_reference_checkpoint(
        state_dict=to_torch_sd(sd), cfg=port_cfg(cfg), device="cpu")
    assert pcfg == port_cfg(cfg)
    assert sorted(got) == sorted(want) == [
        "llm", "mm_projector", "region_fea_adapter", "sam",
        "text_hidden_fcs"]
    assert_tree_equal(got, want, torch.bfloat16 if dtype == jnp.bfloat16
                      else torch.float32)


def test_load_reference_checkpoint_round_trip_through_the_port():
    """Port tree -> the port's medplib_to_hf -> the port's loader: the
    source tree back, leaf for leaf (the dense MLP placeholder of an
    all-MoE stack stripped, as serving does)."""
    from medplib_tpu_torch.models import medplib as tm
    from medplib_tpu_torch.models import moe_llama as tmoe
    cfg = port_cfg(_medplib(True)[0])
    src = tm.init_medplib(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, "cpu")
    src["llm"] = tmoe.strip_dense_mlp(src["llm"], cfg.llm, cfg.moe)
    _, got = texport.load_reference_checkpoint(
        state_dict=thx.medplib_to_hf(src, cfg), cfg=cfg, device="cpu")
    got["llm"] = tmoe.strip_dense_mlp(got["llm"], cfg.llm, cfg.moe)
    got["clip"] = src["clip"]
    assert_tree_equal(got, snap(jax.tree_util.tree_map(
        lambda x: x.float().numpy(), src)), torch.bfloat16)


def _write_shards(sd, path, n=2):
    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    for i in range(n):
        torch.save({k: sd[k].clone() for k in keys[i::n]},
                   os.path.join(path, f"pytorch_model-{i + 1:05d}-of-"
                                      f"{n:05d}.bin"))


def test_load_reference_checkpoint_from_bin_dir(tmp_path):
    """A merged export written as torch.save shards (bf16), a standalone
    SAM .pth ({"model": ...}) and a CLIP directory."""
    cfg, p = _medplib(True, jnp.bfloat16)
    sd = jhx.medplib_to_hf(p, cfg)
    _write_shards(to_torch_sd(sd), str(tmp_path / "hf"))
    sam_sd = to_torch_sd(jhx.sam_to_torch(p["sam"], cfg.sam))
    torch.save({"model": sam_sd}, str(tmp_path / "sam.pth"))
    clip_sd = {"vision_model." + k: v for k, v in to_torch_sd(
        _clip_to_hf(p["clip"], cfg.vision)).items()}
    _write_shards(clip_sd, str(tmp_path / "clip"), n=1)

    want = _jax_loaded(sd, cfg)
    want["clip"] = p["clip"]
    _, got = texport.load_reference_checkpoint(
        str(tmp_path / "hf"), sam_path=str(tmp_path / "sam.pth"),
        clip_dir=str(tmp_path / "clip"), cfg=port_cfg(cfg), device="cpu")
    assert_tree_equal(got, want, torch.bfloat16)


def _clip_to_hf(clip, vcfg):
    """The HF CLIPVisionModel keys of a clip tree (no JAX inverse exists):
    the reverse of clip_vision_from_hf, for the directory test."""
    sd = {}
    e = clip["embeddings"]
    sd["embeddings.class_embedding"] = e["class_embedding"]
    sd["embeddings.patch_embedding.weight"] = np.transpose(
        e["patch_embedding"]["kernel"], (3, 2, 0, 1))
    sd["embeddings.position_embedding.weight"] = \
        e["position_embedding"]["embedding"]
    for n in ("pre_layrnorm", "post_layernorm"):
        sd[n + ".weight"] = clip[n]["weight"]
        sd[n + ".bias"] = clip[n]["bias"]
    lay = clip["layers"]
    for i in range(vcfg.num_layers):
        b = f"encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            sd[b + n + ".weight"] = lay[n]["weight"][i]
            sd[b + n + ".bias"] = lay[n]["bias"][i]
        for n, node in (("self_attn.q_proj", lay["attn"]["q_proj"]),
                        ("self_attn.k_proj", lay["attn"]["k_proj"]),
                        ("self_attn.v_proj", lay["attn"]["v_proj"]),
                        ("self_attn.out_proj", lay["attn"]["out_proj"]),
                        ("mlp.fc1", lay["mlp"]["fc1"]),
                        ("mlp.fc2", lay["mlp"]["fc2"])):
            sd[b + n + ".weight"] = np.ascontiguousarray(node["kernel"][i].T)
            sd[b + n + ".bias"] = node["bias"][i]
    return sd


def test_load_reference_checkpoint_from_safetensors_dir(tmp_path,
                                                        monkeypatch):
    st = pytest.importorskip("safetensors.torch")
    cfg, p = _medplib(True, jnp.bfloat16)
    sd = jhx.medplib_to_hf(p, cfg)
    tsd = {k: v.contiguous() for k, v in to_torch_sd(sd).items()}
    os.makedirs(tmp_path / "st")
    st.save_file(tsd, str(tmp_path / "st" / "model.safetensors"))
    _, got = texport.load_reference_checkpoint(str(tmp_path / "st"),
                                               cfg=port_cfg(cfg),
                                               device="cpu")
    assert_tree_equal(got, _jax_loaded(sd, cfg), torch.bfloat16)
    # without the package: the port reads the shards with its own reader
    monkeypatch.setitem(sys.modules, "safetensors", None)
    again = texport.load_hf_torch_dir(str(tmp_path / "st"), "cpu")
    assert sorted(again) == sorted(tsd)
    for k, v in tsd.items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k
    with pytest.raises(FileNotFoundError):
        texport.load_hf_torch_dir(str(tmp_path), "cpu")
