"""The training modules of medplib_tpu_torch against their JAX functions on
the CPU: losses, LoRA injection / linears / trainable mask, the optimizer
against optax, LoRA dropout under remat, and the checkpoint manager.
Inputs are made with numpy from a seed and handed to both sides; params are
bridged leaf for leaf. Float32 unless a test says otherwise; tolerance
1e-5 (the same f32 math summed in another order) unless stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import llama as jllama
from medplib_tpu.models import losses as jlosses
from medplib_tpu.train import lora as jlora
from medplib_tpu.train import optimizer as jopt
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.models import losses as tlosses
from medplib_tpu_torch.train import lora as tlora
from medplib_tpu_torch.train import optimizer as topt
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import quantize as tq
from medplib_tpu_torch.utils import tree as tree_util
from medplib_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(3)


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
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_cross_entropy_loss():
    """Shifted CE with IGNORE_INDEX targets, incl. an all-ignored row."""
    logits = RNG.normal(size=(3, 9, 50)).astype(np.float32) * 3
    labels = RNG.integers(0, 50, size=(3, 9))
    labels[0, :4] = -100
    labels[2] = -100
    close(tlosses.cross_entropy_loss(_t(logits), _t(labels)),
          jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    none = np.full((2, 5), -100)
    close(tlosses.cross_entropy_loss(_t(logits[:2, :5]), _t(none)), 0.0)


@pytest.mark.parametrize("with_valid", [True, False])
def test_mask_losses(with_valid):
    """BCE, Dice, IoU and focal per mask, masked mean over masks."""
    pred = (RNG.normal(size=(4, 16, 16)) * 4).astype(np.float32)
    gt = (RNG.uniform(size=(4, 16, 16)) > 0.5).astype(np.float32)
    iou = RNG.uniform(size=(4,)).astype(np.float32)
    valid = np.array([True, False, True, True]) if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    tp, tg = _t(pred), _t(gt)
    close(tlosses.sigmoid_ce_loss(tp, tg, tv),
          jlosses.sigmoid_ce_loss(jp, jg, jv))
    close(tlosses.dice_loss(tp, tg, tv), jlosses.dice_loss(jp, jg, jv))
    close(tlosses.mask_iou_loss(tp, tg, _t(iou), tv),
          jlosses.mask_iou_loss(jp, jg, jnp.asarray(iou), jv))
    close(tlosses.focal_loss(tp, tg, tv), jlosses.focal_loss(jp, jg, jv))


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def _qlora_llama():
    """Tiny LLaMA, int8-quantized (kernels >= 4096 elements), LoRA q/v
    r=4 with non-zero lora_b so the branch is live."""
    cfg = jc.LlamaConfig.tiny()
    p = jllama.init_llama(jax.random.PRNGKey(0), cfg)
    p = jq.quantize_tree(p)
    p = jlora.inject(jax.random.PRNGKey(1), p, ("q_proj", "v_proj"), r=4)
    for name in ("q_proj", "v_proj"):
        node = p["layers"]["attn"][name]
        node["lora_b"] = jnp.asarray(
            RNG.normal(size=node["lora_b"].shape) * 0.05).astype(
                node["lora_b"].dtype)
    return cfg, p


def test_inject_matches_reference_shapes():
    """Same adapter paths, shapes and dtypes as the JAX injection (bf16
    beside int8 kernels, the float dtype beside float ones); lora_b = 0."""
    cfg = jc.LlamaConfig.tiny()
    for quant in (False, True):
        p = jllama.init_llama(jax.random.PRNGKey(0), cfg)
        if quant:
            p = jq.quantize_tree(p)
        want = jlora.inject(jax.random.PRNGKey(1), p, ("q_proj", "v_proj",
                                                      "down_proj"), r=4)
        src = bridge(p)
        got = tlora.inject(torch.Generator().manual_seed(1), src,
                           ("q_proj", "v_proj", "down_proj"), r=4)
        assert "lora_a" not in src["layers"]["attn"]["q_proj"]
        wl = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        gl = tree_util.leaves_with_paths(got)
        assert len(wl) == len(gl)
        for path, leaf in gl:
            w = wl[tuple(jax.tree_util.DictKey(k) for k in path)]
            assert tuple(leaf.shape) == w.shape, path
            assert str(leaf.dtype).split(".")[-1] == str(w.dtype), path
            if path[-1] == "lora_b":
                assert not bool(leaf.any())
        with pytest.raises(ValueError, match="no modules"):
            tlora.inject(torch.Generator(), src, ("nope",), r=4)


@pytest.mark.parametrize("rows", [5, 520])
def test_lora_linear_and_linear_t(rows):
    """y = x W + (x A) B * 2 with bridged adapters: int8 kernels with bf16
    adapters (promoted to f32 as JAX does), transposed and not; >= 512
    rows under act-quant stay weight-only because of the adapters."""
    cfg, p = _qlora_llama()
    lp = jax.tree_util.tree_map(lambda a: a[1], p["layers"])
    tp = bridge(lp)
    x = RNG.normal(size=(rows, cfg.hidden_size)).astype(np.float32)
    for name, jf, tf in (("q_proj", jlora.linear_t, tlora.linear_t),
                         ("o_proj", jlora.linear, tlora.linear)):
        node, tnode = lp["attn"][name], tp["attn"][name]
        if name == "o_proj":       # a plain linear with adapters and bias
            node = dict(node, lora_a=lp["attn"]["q_proj"]["lora_a"],
                        lora_b=lp["attn"]["q_proj"]["lora_b"],
                        bias=jnp.ones((cfg.hidden_size,)))
            tnode = bridge(node)
        with jq.dynamic_act_quant(True):
            want = jax.jit(lambda n, a: jf(n, a))(node, jnp.asarray(x))
        with tq.dynamic_act_quant(True):
            got = tf(tnode, _t(x))
        close(got, want)


def test_trainable_mask_matches_reference():
    """The same mask on the same QLoRA tree: adapters and float sft leaves
    trainable, quantized nodes (lm_head here) frozen."""
    _, p = _qlora_llama()
    sft = ("lm_head", "embed_tokens", "norm")
    want = jlora.trainable_mask(p, sft)
    got = tlora.trainable_mask(bridge(p), sft)
    assert got == want
    assert got["lm_head"]["kernel"] is False
    assert got["embed_tokens"]["embedding"] is True
    assert got["layers"]["attn"]["q_proj"]["lora_a"] is True


def test_lora_dropout_same_masks_under_remat():
    """At rate 0.5 the masks depend only on (seed, layer, call site), so a
    layer recomputed by checkpoint draws its forward's masks: remat on and
    off give the same loss and equal gradients. Another seed gives another
    loss, and rate 0 equals running without the dropout context."""
    cfg, p = _qlora_llama()
    tcfg = port_cfg(cfg)
    x = _t(RNG.normal(size=(2, 7, cfg.hidden_size)).astype(np.float32))

    def grads(remat, seed=5, rate=0.5):
        tp = bridge(p)
        leaves = [tp["layers"]["attn"][n][a] for n in ("q_proj", "v_proj")
                  for a in ("lora_a", "lora_b")]
        for leaf in leaves:
            leaf.requires_grad_(True)
        if rate is None:
            h, _, _ = tllama.forward(tp, tcfg, x, remat=remat)
        else:
            with tlora.lora_dropout_ctx(seed, rate):
                h, _, _ = tllama.forward(tp, tcfg, x, remat=remat)
        loss = (h.float() ** 2).mean()
        return [loss] + list(torch.autograd.grad(loss, leaves))

    on, off = grads(True), grads(False)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert not torch.equal(grads(True, seed=6)[0], on[0])
    for a, b in zip(grads(True, rate=0.0), grads(True, rate=None)):
        assert torch.equal(a, b)


def test_llama_remat_matches_plain_forward():
    """remat changes memory, not values (JAX's forward as the reference)."""
    cfg, p = _qlora_llama()
    x = RNG.normal(size=(2, 6, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    want, _, _ = jllama.forward(p, cfg, jnp.asarray(x), jnp.asarray(mask),
                                remat=True)
    got, _, _ = tllama.forward(bridge(p), port_cfg(cfg), _t(x), _t(mask),
                               remat=True)
    close(got, want)
    with pytest.raises(ValueError, match="remat"):
        tllama.forward(bridge(p), port_cfg(cfg), _t(x), remat=True,
                       cache=tllama.KVCache.init(port_cfg(cfg), 2, 6,
                                                 device="cpu"))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 1, 2, 7, 50, 120])
def test_schedule_matches_optax(count):
    cfg = jc.TrainConfig(lr=3e-4, warmup_steps=5, total_steps=100,
                         min_lr_ratio=0.1)
    want = np.float32(jopt.warmup_decay_schedule(cfg)(count))
    got = topt.warmup_decay_schedule(port_cfg(cfg))(count)
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [100.0, 0.05])
def test_optimizer_matches_optax(dtype, clip):
    """Three masked updates (the first at lr 0) on a tree of two trainable
    leaves and one frozen one, against optax.masked(chain(clip, adamw))
    run op by op: moments in the leaf dtype, eps outside the sqrt, weight
    decay before the lr, clipping triggered (0.05) or not (100). float32
    within 1e-6 relative; bfloat16 equal up to one bf16 ulp (XLA and
    torch may fuse a product and a sum differently)."""
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    cfg = jc.TrainConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         weight_decay=0.1, grad_clip_norm=clip)
    shapes = {"a": (6, 5), "b": (7,), "frozen": (3,)}
    params = {k: jnp.asarray(RNG.normal(size=s)).astype(jdt)
              for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    tx = jopt.make_optimizer(cfg, mask)
    jstate = tx.init(params)
    opt = topt.make_optimizer(port_cfg(cfg), mask)
    tparams = {k: _t(np.asarray(v, np.float32)).to(tdt)
               for k, v in params.items()}
    tstate = opt.init(tparams)
    assert len(tstate.mu) == 2          # frozen leaves get no state
    for step in range(3):
        g = {k: jnp.asarray(RNG.normal(size=s) * 0.3).astype(jdt)
             for k, s in shapes.items()}
        g["frozen"] = jnp.zeros((), jnp.float32)
        upd, jstate = tx.update(g, jstate, params)
        params = optax.apply_updates(params, upd)
        tg = [_t(np.asarray(g[k], np.float32)).to(tdt) for k in ("a", "b")]
        sel = opt.select(tparams)
        tu, tstate = opt.update(tg, tstate, sel)
        new = iter([(p + u).to(p.dtype) for p, u in zip(sel, tu)])
        tparams = tree_util.unflatten(
            tparams, [next(new) if m else p for p, m in zip(
                tree_util.leaves(tparams), tree_util.leaves(mask))])
        for k in ("a", "b", "frozen"):
            want = np.asarray(params[k], np.float32)
            got = tparams[k].float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                assert np.all(np.abs(got - want) <= np.abs(want) * 2 ** -7
                              + 1e-6), (step, k)
    assert tstate.count == 3


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_manager_save_restore_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    tmpl = {"w": torch.zeros(3, dtype=torch.bfloat16),
            "l": [torch.zeros(2, dtype=torch.int8)],
            "step": torch.tensor(0)}
    assert mgr.restore(tmpl) == (tmpl, None)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.full((3,), float(s), dtype=torch.bfloat16),
                     "l": [torch.full((2,), s, dtype=torch.int8)],
                     "step": torch.tensor(s)})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    got, step = mgr.restore(tmpl)
    assert step == 3 and got["w"].dtype == torch.bfloat16
    assert got["w"].tolist() == [3.0] * 3 and got["l"][0].tolist() == [3, 3]
    got, step = mgr.restore(tmpl, step=2)
    assert int(got["step"]) == 2
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(4), "l": tmpl["l"],
                     "step": tmpl["step"]})
