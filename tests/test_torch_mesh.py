"""The port's mesh and sharding rules (medplib_tpu_torch/parallel/mesh.py)
against the JAX package's (medplib_tpu/parallel/mesh.py), in one process:

- param_spec leaf for leaf on the tiny MoE tree (f32, with LoRA), the
  tiny tree in the flagship quantization (int8 attention / lm_head, int4h
  experts with their scales), a packed dense tree, and the flagship's own
  shapes (jax.eval_shape of the JAX init, no memory);
- the rank layout of make_mesh's reshape (rank = (d * E + e) * M + m);
- shard_params / shard_spec (the language model split, CLIP and SAM
  whole), host_local_batch_to_global, and the collectives of a mesh
  without a process group (identities).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import medplib as jm
from medplib_tpu.parallel import mesh as jmesh
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.parallel import mesh as pm
from medplib_tpu_torch.train import lora as tlora
from medplib_tpu_torch.utils import tree as tree_util
from medplib_tpu_torch.utils.quantize import (quantize_flagship_moe,
                                              quantize_tree)

torch.set_num_threads(1)


def _tiny_cfg(moe=True):
    cfg = tc.MedplibConfig.tiny()
    if moe:
        cfg = dataclasses.replace(cfg, moe=tc.MoeConfig(
            enable=True, num_experts=2, top_k=1))
    return cfg


def _trees():
    """name -> a port params tree (CPU)."""
    gen = torch.Generator().manual_seed(0)
    cfg = _tiny_cfg()
    f32 = tm.init_medplib(gen, cfg, torch.float32, "cpu")
    lora = dict(f32, llm=tlora.inject(gen, f32["llm"],
                                      ("q_proj", "v_proj", "o_proj",
                                       "gate_proj"), 4))
    quant = quantize_flagship_moe(tm.init_medplib(gen, cfg, torch.float32,
                                                  "cpu"), 4, 8)
    dense = tm.init_medplib(gen, _tiny_cfg(False), torch.float32, "cpu")
    dense["llm"] = tllama.pack_inference(dense["llm"])
    packed = quantize_tree(dense, bits=8)
    return {"f32_lora": lora, "flagship_quant": quant, "packed": packed}


def _jax_spec(path, leaf):
    return tuple(jmesh.param_spec([DictKey(k) for k in path], leaf))


@pytest.mark.parametrize("name", ["f32_lora", "flagship_quant", "packed"])
def test_param_spec_equals_jax(name):
    tree = _trees()[name]
    specs = {}
    for path, leaf in tree_util.leaves_with_paths(tree):
        want = _jax_spec(path, np.zeros((1,) * leaf.dim()))
        got = pm.param_spec(path, leaf)
        assert got == want, ("/".join(path), got, want)
        specs["/".join(path)] = got
    # the rules do split something here, and leave the expert kernels whole
    assert any(s for s in specs.values())
    for k, s in specs.items():
        if "experts" in k and k.endswith("kernel"):
            assert s == (), k


def test_param_spec_equals_jax_at_flagship_shapes():
    """The flagship tree's own leaves (shapes only, from jax.eval_shape of
    the JAX init): equal specs, and every split dimension divides by 2."""
    cfg = jc.MedplibConfig(
        llm=jc.LlamaConfig(num_layers=2),
        moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1),
        seg_token_idx=32000, vocab_size_padded=32320)
    shapes = jax.eval_shape(lambda: jm.init_medplib(jax.random.PRNGKey(0),
                                                    cfg))
    n_split = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        want = tuple(jmesh.param_spec(kp, leaf))
        fake = torch.empty(leaf.shape, device="meta")
        assert pm.param_spec(path, fake) == want, path
        for dim, a in enumerate(want):
            if a is not None:
                n_split += 1
                assert leaf.shape[dim] % 2 == 0
    assert n_split >= 8


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 1), (1, 2, 1),
                                   (1, 1, 2), (2, 2, 1), (1, 2, 2),
                                   (2, 2, 2), (3, 2, 1)])
def test_rank_layout_is_make_mesh_reshape(shape):
    """make_mesh reshapes the device list to (data, expert, model): the
    device at [d, e, m] is rank (d * E + e) * M + m, and the row shard of
    (d, e) is d * E + e."""
    cfg = tc.MeshConfig(*shape)
    grid = np.arange(cfg.total).reshape(shape)
    for rank in range(cfg.total):
        m = pm.Mesh(cfg, rank)
        d, e, mm = (m.coords[a] for a in pm.AXIS_NAMES)
        assert grid[d, e, mm] == rank
        assert m.index(pm.ROWS) == d * shape[1] + e
        assert m.index(pm.AXIS_NAMES) == rank
        assert m.size(pm.ROWS) == shape[0] * shape[1]


def test_shard_params_splits_the_language_model_only():
    tree = _trees()["flagship_quant"]
    for coord in range(2):
        mesh = pm.Mesh(tc.MeshConfig(1, 2, 2), rank=coord * 3)
        local = pm.shard_params(mesh, tree)
        for (path, full), (_, part) in zip(
                tree_util.leaves_with_paths(tree),
                tree_util.leaves_with_paths(local)):
            spec = pm.shard_spec(path, full)
            if path[0] in ("clip", "sam"):
                assert spec == () and part is full
            want = list(full.shape)
            for dim, a in enumerate(spec):
                if a is not None:
                    want[dim] //= 2
                    blk = full.narrow(dim, mesh.coords[a] * want[dim],
                                      want[dim])
                    assert torch.equal(part, blk.contiguous()) or \
                        len([x for x in spec if x]) > 1
            assert list(part.shape) == want, path
    # the JAX rule names CLIP's q / k / v (as a layout); the port keeps
    # them whole
    clip_q = ("clip", "layers", "attn", "q_proj", "kernel")
    q = tree["clip"]["layers"]["attn"]["q_proj"]["kernel"]
    assert pm.param_spec(clip_q, q) != () and pm.shard_spec(clip_q, q) == ()


def test_shard_spec_keeps_packed_kernels_whole():
    """param_spec splits pack_inference's qkv_proj / gateup_proj on their
    concatenated output axis (as JAX's does); shard_params keeps them whole
    for tp.packed_local to cut."""
    tree = _trees()["packed"]
    mesh = pm.Mesh(tc.MeshConfig(1, 1, 2), rank=1)
    local = pm.shard_params(mesh, tree)
    seen = 0
    for (path, full), (_, part) in zip(tree_util.leaves_with_paths(tree),
                                       tree_util.leaves_with_paths(local)):
        if "qkv_proj" in path or "gateup_proj" in path:
            seen += 1
            assert pm.shard_spec(path, full) == () and part is full, path
            if path[-1] == "kernel":
                assert pm.param_spec(path, full) != (), path
    assert seen >= 4


def test_host_local_batch_and_identity_collectives():
    cfg = tc.MeshConfig(2, 2, 1)
    x = torch.arange(24.).reshape(8, 3)
    ga = torch.arange(48.).reshape(2, 8, 3)
    for rank in range(4):
        m = pm.Mesh(cfg, rank)
        assert torch.equal(pm.host_local_batch_to_global(m, x),
                           x[rank * 2:(rank + 1) * 2])
        assert torch.equal(pm.host_local_batch_to_global(m, ga, dim=1),
                           ga[:, rank * 2:(rank + 1) * 2])
    assert pm.batch_sharding(pm.Mesh(cfg)) == (pm.ROWS,)
    one = pm.local_mesh()
    y = torch.randn(4, 6, requires_grad=True)
    for out in (one.all_reduce(y, pm.ROWS), one.all_gather(y, "model", 1),
                one.reduce_scatter(y, "expert")):
        assert out is y
    assert pm.current_mesh() is None and pm.row_sum(y) is y
    with pm.set_mesh(one):
        assert pm.current_mesh() is one and pm.row_shards() == 1
    assert pm.current_mesh() is None
