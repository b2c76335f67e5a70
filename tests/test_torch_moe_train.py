"""The rest of training in medplib_tpu_torch against the JAX package on the
CPU: the top-1 / top-2 gates and the einsum dispatch, Residual-MoE through
every dispatch, mixed dense / MoE layer stacks (forward, decode, extend),
the MoE train step (LoRA and full fine-tuning, ga 1 and 2), region
training (rp_flag), Trainer.validate, fit with validation, and the expert
surgery from donor stacks.

Inputs come from numpy seeds at tiny sizes; JAX params are carried over
leaf for leaf (utils/convert). Float32 unless a test says otherwise. The
JAX side runs under jax.jit (its compiled numerics are the port's); the
gmm dispatch runs the Pallas kernel in interpret mode there and the plain
K3 here. Tolerances are stated per test.

Forced drops: a skewed router (inputs share a large feature, the router
weights it toward expert 0) sends most tokens to one expert, so capacity
1.5 drops tokens; each such case checks that drops happened."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import llama as jllama
from medplib_tpu.models import medplib as jm
from medplib_tpu.models import moe_llama as jml
from medplib_tpu.ops import moe as jmoe
from medplib_tpu.train import lora as jlora
from medplib_tpu.train import trainer as jtr
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.models import moe_llama as tml
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.train import trainer as ttr
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import tree as tree_util

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


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


def torch_batch(batch, lead=False):
    b = tm.Batch(**{k: torch.from_numpy(np.array(getattr(batch, k)))
                    for k in tm.Batch._fields})
    return tm.Batch(*[x[None] for x in b]) if lead else b


@pytest.fixture()
def drops(monkeypatch):
    """Counts the tokens the port's sort dispatch drops."""
    seen = []
    real = tmoe.sort_dispatch

    def counting(logits, k, capacity):
        d = real(logits, k, capacity)
        seen.append(int((d.token_slot >= logits.shape[1] * capacity).sum()))
        return d

    monkeypatch.setattr(tmoe, "sort_dispatch", counting)
    return seen


# ---------------------------------------------------------------------------
# gates and dispatches of one layer
# ---------------------------------------------------------------------------

def _skewed_logits(rng, s, e, skew):
    logits = rng.normal(size=(s, e)).astype(np.float32)
    if skew:
        logits[:, 0] += 2.0      # a bias column: most tokens pick expert 0
    return logits


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("cf", [1.0, 1.5])
@pytest.mark.parametrize("k", [1, 2])
def test_gate_matches_jax(k, cf, skew):
    """top1_gate / top2_gate through `gate`: combine weights (1e-6),
    dispatch mask, aux loss (1e-6) and pre-drop counts (equal)."""
    rng = np.random.default_rng(10 * k + int(cf * 2) + skew)
    s, e = 37, 3
    logits = _skewed_logits(rng, s, e, skew)
    cap = jmoe.capacity_for(s, e, cf, 0)
    want = jax.jit(lambda l: jmoe.gate(l, k, cap))(jnp.asarray(logits))
    got = tmoe.gate(_t(logits), k, cap)
    close(got.combine, want.combine, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.dispatch.numpy(),
                                  np.asarray(want.dispatch))
    close(got.aux_loss, want.aux_loss, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.expert_counts.numpy(),
                                  np.asarray(want.expert_counts))
    kept = int(got.dispatch.sum())
    if skew:
        assert kept < s * k           # tokens were dropped
    with pytest.raises(NotImplementedError):
        tmoe.gate(_t(logits), 3, cap)


def _layer_params(rng, e, h, m, residual=False, skew=False):
    p = {
        "router": {"kernel": rng.normal(size=(h, e)).astype(np.float32)
                   * h ** -0.5},
        "experts": {
            "gate_proj": {"kernel": rng.normal(size=(e, h, m)).astype(
                np.float32) * 0.1},
            "up_proj": {"kernel": rng.normal(size=(e, h, m)).astype(
                np.float32) * 0.1},
            "down_proj": {"kernel": rng.normal(size=(e, m, h)).astype(
                np.float32) * 0.1},
        },
    }
    if skew:
        p["router"]["kernel"][0] = 0.0
        p["router"]["kernel"][0, 0] = 1.0
    if residual:
        p["residual_mlp"] = {n: {"kernel": rng.normal(size=shape).astype(
            np.float32) * 0.1} for n, shape in (("gate_proj", (h, m)),
                                                ("up_proj", (h, m)),
                                                ("down_proj", (m, h)))}
        p["coefficient"] = {
            "kernel": rng.normal(size=(h, 2)).astype(np.float32) * 0.3,
            "bias": np.array([0.2, -0.1], np.float32)}
    return jax.tree_util.tree_map(jnp.asarray, p)


def _layer_input(rng, b, t, h, skew):
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    if skew:
        x[..., 0] = 3.0          # every token carries the skewed feature
    return x


@pytest.mark.parametrize("cf", [1.0, 1.5])
@pytest.mark.parametrize("k", [1, 2])
def test_einsum_dispatch_matches_jax_and_sort(k, cf, drops):
    """moe_mlp(dispatch_mode="einsum") equals JAX's (1e-5) and the port's
    sort dispatch equals the einsum (1e-5, aux 1e-6), with a skewed
    router that drops tokens at both capacity factors."""
    rng = np.random.default_rng(20 + k)
    e, h, m = 4, 16, 32
    p = _layer_params(rng, e, h, m, skew=True)
    x = _layer_input(rng, 2, 11, h, skew=True)
    mcfg = jc.MoeConfig(enable=True, num_experts=e, top_k=k,
                        capacity_factor=cf, min_capacity=0)
    want, aux_j = jax.jit(lambda q, v: jmoe.moe_mlp(
        q, v, mcfg, dispatch_mode="einsum"))(p, jnp.asarray(x))
    tp = bridge(p)
    y_ein, aux_e = tmoe.moe_mlp(tp, _t(x), port_cfg(mcfg),
                                dispatch_mode="einsum")
    y_sort, aux_s = tmoe.moe_mlp(tp, _t(x), port_cfg(mcfg),
                                 dispatch_mode="sort")
    close(y_ein, want)
    close(aux_e, aux_j, rtol=1e-6, atol=1e-6)
    close(y_sort, y_ein.numpy())
    close(aux_s, aux_e.numpy(), rtol=1e-6, atol=1e-6)
    assert drops and drops[-1] > 0
    with pytest.raises(ValueError, match="dispatch_mode"):
        tmoe.moe_mlp(tp, _t(x), port_cfg(mcfg), dispatch_mode="bogus")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sort", "einsum", "gmm"])
def test_residual_moe_matches_jax(mode, dtype):
    """Residual-MoE (moe_llama.residual_mix of moe_mlp's output) after
    each dispatch (gmm: the plain K3 against the Pallas kernel in
    interpret mode, at 1040 rows). f32: 1e-5 (gmm 2e-5:
    f32 sums of K = 32 and 64 in another order). bf16 experts, residual
    and inputs: the coefficient in f32 then cast, y·c0 + r·c1 in bf16;
    2e-2 abs on outputs of size ~1 (two bf16 steps: the compiled JAX keeps
    some bf16 products unrounded inside its fusions)."""
    rng = np.random.default_rng(31)
    e, h, m = 2, 32, 64
    p = _layer_params(rng, e, h, m, residual=True)
    t = 520 if mode == "gmm" else 9
    x = _layer_input(rng, 2, t, h, skew=False)
    mcfg = jc.MoeConfig(enable=True, num_experts=e, top_k=1,
                        capacity_factor=1.5, eval_capacity_factor=2.0)
    jd = jnp.dtype(dtype)
    p = jax.tree_util.tree_map(lambda a: a.astype(jd), p)
    xj = jnp.asarray(x).astype(jd)
    want, aux_j = jax.jit(lambda q, v: jmoe.moe_mlp(
        q, v, mcfg, train=False, dispatch_mode=mode))(p, xj)
    tp, tx = bridge(p), bridge(xj)
    y, aux_t = tmoe.moe_mlp(tp, tx, port_cfg(mcfg), train=False,
                            dispatch_mode=mode)
    got = tml.residual_mix(tp, tx, y)
    assert got.dtype == getattr(torch, dtype)
    close(aux_t, aux_j, rtol=1e-5, atol=1e-6)
    if dtype == "float32":
        tol = dict(rtol=2e-5, atol=2e-5) if mode == "gmm" else TOL
        close(got, want, **tol)
    else:
        close(got, want.astype(jnp.float32), rtol=0, atol=2e-2)


def test_residual_moe_after_fused_decode():
    """The residual composes after the fused decode dispatch (K2's plain
    version on int4h experts padded to M = 1024, whole-stack path; the
    residual copy int8): JAX's forward_decode within 1e-3 norm-relative
    (the A8 decode quantizes activations per row and block: a last-bit
    difference can flip one quant step, as in the W4A8 module tests;
    5.1e-4 measured)."""
    from medplib_tpu.utils import quantize as jq
    cfg = jc.LlamaConfig(vocab_size=64, hidden_size=512,
                         intermediate_size=200, num_layers=2, num_heads=8,
                         num_kv_heads=4, head_dim=64)
    mcfg = jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                        use_residual=True, moe_mode="dense")
    p = jml.init_moe_llama(jax.random.PRNGKey(4), cfg, mcfg, jnp.float32)
    p["layers"]["moe"]["coefficient"]["bias"] = jnp.asarray(
        [[0.3, -0.2], [0.1, 0.4]], jnp.float32)
    q = jq.quantize_flagship_moe({"llm": p}, 4, 8)["llm"]
    assert "residual_mlp" in q["layers"]["moe"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 6, 512)).astype(np.float32)
    e = rng.normal(size=(3, 1, 512)).astype(np.float32)
    cache = jllama.KVCache.init(cfg, 3, 8, jnp.float32)
    _, cj, _ = jax.jit(lambda pp, v, c: jml.forward(
        pp, cfg, mcfg, v, cache=c, train=False))(q, jnp.asarray(x), cache)
    hj, _ = jax.jit(lambda pp, v, c: jml.forward_decode(
        pp, cfg, mcfg, v, c))(q, jnp.asarray(e), cj)
    tq_ = bridge(q)
    tcfg, tmcfg = port_cfg(cfg), port_cfg(mcfg)
    layer0 = tllama.layer_params(tq_["layers"]["moe"]["experts"], 0)
    assert tmoe.plan_route(layer0, 2, 1, 3, decode=True, capacity=3,
                           all_moe=True).dispatch == "fused_decode"
    tcache = tllama.KVCache.init(tcfg, 3, 8, torch.float32, device="cpu")
    _, tcache, _ = tml.forward(tq_, tcfg, tmcfg, _t(x), cache=tcache,
                               train=False)
    ht, _ = tml.forward_decode(tq_, tcfg, tmcfg, _t(e), tcache)
    hj = np.asarray(hj)
    assert np.linalg.norm(ht.numpy() - hj) / np.linalg.norm(hj) <= 1e-3


# ---------------------------------------------------------------------------
# layer stacks
# ---------------------------------------------------------------------------

MIXED = {"sparse": dict(moe_mode="sparse"),
         "first_half": dict(moe_mode="first_half"),
         "layers_idx": dict(moe_layers_idx=(1, 2))}


def _mixed_llm(kind, residual=False):
    cfg = dataclasses.replace(jc.LlamaConfig.tiny(vocab_size=64),
                              num_layers=4)
    mcfg = jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                        capacity_factor=1.5, use_residual=residual,
                        **MIXED[kind])
    p = jml.init_moe_llama(jax.random.PRNGKey(7), cfg, mcfg, jnp.float32)
    return cfg, mcfg, p


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("kind", list(MIXED))
def test_mixed_stack_forward_decode_extend(kind, residual):
    """A mixed dense / MoE stack (and its Residual-MoE form) in forward
    (train: the aux sum of the MoE layers only; eval with a KV cache),
    forward_decode and forward_extend, against JAX: hidden states and
    caches 1e-5, aux 1e-6."""
    cfg, mcfg, p = _mixed_llm(kind, residual)
    tp, tcfg, tmcfg = bridge(p), port_cfg(cfg), port_cfg(mcfg)
    flags = tml.moe_flags(tcfg, tmcfg)
    assert 0 < flags.sum() < len(flags)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 7, 128)).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    hj, _, aj = jax.jit(lambda pp, v: jml.forward(
        pp, cfg, mcfg, v, remat=True, train=True))(p, jnp.asarray(x))
    ht, _, at = tml.forward(tp, tcfg, tmcfg, _t(x), remat=True, train=True)
    close(ht, hj)
    close(at, aj, rtol=1e-6, atol=1e-6)
    assert float(at) > 0

    cache = jllama.KVCache.init(cfg, 2, 12, jnp.float32)
    hj, cj, _ = jax.jit(lambda pp, v, m, c: jml.forward(
        pp, cfg, mcfg, v, m, cache=c, train=False))(
            p, jnp.asarray(x), jnp.asarray(mask), cache)
    tcache = tllama.KVCache.init(tcfg, 2, 12, torch.float32, device="cpu")
    ht, tcache, _ = tml.forward(tp, tcfg, tmcfg, _t(x), _t(mask),
                                cache=tcache, train=False)
    close(ht, hj)
    close(tcache.k, cj.k)
    e = rng.normal(size=(2, 1, 128)).astype(np.float32)
    hj, cj = jax.jit(lambda pp, v, c: jml.forward_decode(
        pp, cfg, mcfg, v, c))(p, jnp.asarray(e), cj)
    ht, tcache = tml.forward_decode(tp, tcfg, tmcfg, _t(e), tcache)
    close(ht, hj)
    close(tcache.v, cj.v)

    cache = jllama.KVCache.init(cfg, 2, 12, jnp.float32)
    tcache = tllama.KVCache.init(tcfg, 2, 12, torch.float32, device="cpu")
    for c0 in (0, 4):
        chunk = x[:, c0:c0 + 3]
        hj, cache = jax.jit(lambda pp, v, c, c0=c0: jml.forward_extend(
            pp, cfg, mcfg, v, c, c0))(p, jnp.asarray(chunk), cache)
        ht, tcache = tml.forward_extend(tp, tcfg, tmcfg, _t(chunk), tcache,
                                        c0)
        close(ht, hj)
    close(tcache.k, cache.k)


def test_init_moe_llama_residual_tree():
    """Residual-MoE init: the same paths and shapes as JAX's; the dense
    copy equals the dense MLP in buffers of its own; bias zeros."""
    cfg = jc.LlamaConfig.tiny(vocab_size=64)
    mcfg = jc.MoeConfig(enable=True, use_residual=True)
    want = jml.init_moe_llama(jax.random.PRNGKey(0), cfg, mcfg, jnp.float32)
    got = tml.init_moe_llama(torch.Generator().manual_seed(0),
                             port_cfg(cfg), port_cfg(mcfg), device="cpu")
    wl = {tuple(getattr(k, "key", k) for k in path): v.shape for path, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    gl = {path: tuple(v.shape) for path, v in
          tree_util.leaves_with_paths(got)}
    assert gl == wl
    moe, mlp = got["layers"]["moe"], got["layers"]["mlp"]
    for n in ("gate_proj", "up_proj", "down_proj"):
        r, d = moe["residual_mlp"][n]["kernel"], mlp[n]["kernel"]
        assert torch.equal(r, d) and r.data_ptr() != d.data_ptr()
    assert not moe["coefficient"]["bias"].any()


# ---------------------------------------------------------------------------
# model: the train step
# ---------------------------------------------------------------------------

def _moe_model(residual=False, mode="dense", top_k=1, cf=1.5, lora=True,
               skew=True):
    """MedplibConfig.tiny with 2 experts; LoRA q/v r=8 with a non-zero
    lora_b. skew: every token embedding shares a large feature that the
    routers weight toward expert 0, so capacity drops tokens."""
    llm = jc.LlamaConfig.tiny()
    if mode != "dense":
        llm = dataclasses.replace(llm, num_layers=4)
    cfg = jc.MedplibConfig.tiny(
        llm=llm,
        moe=jc.MoeConfig(enable=True, num_experts=2, top_k=top_k,
                         capacity_factor=cf, use_residual=residual,
                         moe_mode=mode, router_aux_loss_coef=0.05))
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    if skew:
        lp = p["llm"]
        lp["embed_tokens"]["embedding"] = \
            lp["embed_tokens"]["embedding"].at[:, 0].add(4.0)
        lp["layers"]["moe"]["router"]["kernel"] = \
            lp["layers"]["moe"]["router"]["kernel"].at[:, 0, 0].add(3.0)
    if lora:
        p["llm"] = jlora.inject(jax.random.PRNGKey(1), p["llm"],
                                ("q_proj", "v_proj"), r=8)
        for n in ("q_proj", "v_proj"):
            node = p["llm"]["layers"]["attn"][n]
            node["lora_b"] = (jax.random.normal(jax.random.PRNGKey(2),
                                                node["lora_b"].shape)
                              * 0.02).astype(node["lora_b"].dtype)
    return cfg, p


def _batches(cfg, ga, t=32, seed=0, region=False):
    bs = [ge._make_batch(cfg, B=2, T=t, rng=np.random.default_rng(seed + i))
          for i in range(ga)]
    if region:
        bs = [_with_region(b, cfg, np.random.default_rng(seed + 10 + i))
              for i, b in enumerate(bs)]
    jb = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *bs)
    tb = tm.Batch(*[torch.stack([torch.from_numpy(np.array(getattr(b, k)))
                                 for b in bs]) for k in tm.Batch._fields])
    return jb, tb


def _compare_steps(cfg, p, jcfg, ga, jb, tb, rp_flag=False):
    """Two make_train_step updates on each side: loss (1e-5 rel),
    grad_norm (1e-4 rel), every metric (1e-5), and the trainable leaves'
    updates: relative Frobenius error <= 1e-3 over all of them, each
    element within lr / 5. Adam's normalized step m / (sqrt(v) + eps)
    turns f32 noise in a gradient that is near zero into a visible
    fraction of lr: 13.7% of lr on one lora_b entry of the top-2 residual
    case, 4% on o_proj without LoRA, 3.3% on the geo sampler's projector
    were the largest measured. The gradients themselves are held to
    jax.grad in test_moe_forward_aux_and_grads_match_jax."""
    state, tx = jtr.create_state(p, jcfg)
    step = jax.jit(jtr.make_train_step(cfg, jcfg, tx, rp_flag=rp_flag))
    tp = bridge(p)
    tstate, ttx = ttr.create_state(tp, port_cfg(jcfg))
    tstep = ttr.make_train_step(port_cfg(cfg), port_cfg(jcfg), ttx,
                                rp_flag=rp_flag)
    for _ in range(2):
        state, metrics = step(state, jb)
        tstate, tmetrics = tstep(tstate, tb)
    assert set(tmetrics) == set(metrics)
    for k, v in metrics.items():
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=rtol,
                                   atol=1e-6, err_msg=k)
    mask = tree_util.leaves(ttx.mask) if ttx.mask is not None else None
    old = tree_util.leaves(tp)
    want = jax.tree_util.tree_leaves(state.params)
    num = den = 0.0
    for i, (g, o, w) in enumerate(zip(tree_util.leaves(tstate.params), old,
                                      want)):
        if mask is not None and not mask[i]:
            assert g is o
            continue
        dp = g.float().numpy() - o.float().numpy()
        dj = np.asarray(w, np.float32) - o.float().numpy()
        assert np.abs(dp - dj).max() <= jcfg.lr / 5
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0 and (num / den) ** 0.5 <= 1e-3
    return tstate


@pytest.mark.parametrize("ga", [1, 2])
@pytest.mark.parametrize("variant", ["top1", "top2_residual_sparse"])
def test_moe_train_step_matches_jax(variant, ga, drops):
    """Two LoRA steps of the MoE model (sort dispatch, router aux loss in
    the CE, remat) against JAX's make_train_step, at ga 1 and 2, with
    drops: top-1 at capacity 1.5 on every layer; top-2 at capacity 1.0
    with Residual-MoE on a sparse stack."""
    if variant == "top1":
        cfg, p = _moe_model()
    else:
        cfg, p = _moe_model(residual=True, mode="sparse", top_k=2, cf=1.0)
    jcfg = jc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          lora_dropout=0.0, grad_accumulation_steps=ga)
    jb, tb = _batches(cfg, ga)
    _compare_steps(cfg, p, jcfg, ga, jb, tb)
    assert drops and max(drops) > 0


def _trainable(tree, mask):
    return [x for x, m in zip(tree_util.leaves(tree),
                              tree_util.leaves(mask)) if m]


@pytest.mark.parametrize("lora", [False, True])
def test_moe_forward_aux_and_grads_match_jax(lora):
    """model_forward's scalars (1e-5) and gradients against jax.grad on a
    sparse Residual-MoE stack, remat on: without LoRA every leaf of the
    MoE subtree (routers, experts, residual copy, coefficient; the
    router's gradient flows through the gates and the aux loss's
    mean-probability term); with LoRA every trainable leaf of the stage's
    mask (adapters and sft modules). 2e-4 of each leaf's largest entry, at
    least 1e-7."""
    cfg, p = _moe_model(residual=True, mode="sparse", lora=lora)
    batch = ge._make_batch(cfg, B=2, T=32, rng=np.random.default_rng(3))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    paths = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in pp)
             for pp, _ in jax.tree_util.tree_flatten_with_path(p)[0]]
    if lora:
        m_lv = jax.tree_util.tree_leaves(
            jlora.trainable_mask(p, jc.TrainConfig().sft_modules))
    else:
        m_lv = [pp[:3] == ("llm", "layers", "moe") for pp in paths]
    train = [x for x, m in zip(leaves, m_lv) if m]

    def loss(tlv):
        it = iter(tlv)
        full = treedef.unflatten([next(it) if m else x
                                  for x, m in zip(leaves, m_lv)])
        out = jm.model_forward(full, cfg, batch, train=True, remat=True)
        return out["loss"], out

    (_, jout), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(train)
    tp = bridge(p)
    tl = [x.requires_grad_(True) for (pp, x), m in zip(
        tree_util.leaves_with_paths(tp), m_lv) if m]
    assert len(tl) == len(train)
    out = tm.model_forward(tp, port_cfg(cfg), torch_batch(batch), remat=True)
    for k in ("loss", "ce_loss", "mask_loss"):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    tg = torch.autograd.grad(out["loss"], tl, allow_unused=True)
    tpaths = [pp for pp, m in zip(paths, m_lv) if m]
    for path, g, w in zip(tpaths, tg, jg):
        w = np.asarray(w, np.float32)
        g = np.zeros_like(w) if g is None else g.numpy()
        tol = max(2e-4 * float(np.abs(w).max()), 1e-7)
        assert np.all(np.abs(g - w) <= tol), path
    named = dict(zip(tpaths, jg))
    key = (("llm", "layers", "attn", "q_proj", "lora_a") if lora
           else ("llm", "layers", "moe", "router", "kernel"))
    assert float(np.abs(np.asarray(named[key])).max()) > 0


@pytest.mark.parametrize("ga", [1, 2])
def test_moe_train_step_no_lora_matches_jax(ga):
    """--no-lora: every leaf trains, the routers too (updates as in
    _compare_steps)."""
    cfg, p = _moe_model(lora=False)
    jcfg = jc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          lora_enable=False, lora_dropout=0.0,
                          grad_accumulation_steps=ga)
    jb, tb = _batches(cfg, ga, seed=4)
    _compare_steps(cfg, p, jcfg, ga, jb, tb)


def _with_region(batch, cfg, rng):
    """One region marker after the image and a 24 x 24-grid region mask
    (tiny CLIP: 4 x 4) per row."""
    from medplib_tpu.config import REGION_TOKEN_INDEX
    g = cfg.vision.image_size // cfg.vision.patch_size
    ids = np.array(batch.input_ids)
    ids[:, 4] = REGION_TOKEN_INDEX
    rm = (rng.uniform(size=(ids.shape[0], 1, g, g)) > 0.4).astype(np.float32)
    return batch._replace(input_ids=jnp.asarray(ids),
                          region_masks=jnp.asarray(rm),
                          region_valid=jnp.ones((ids.shape[0], 1), bool))


@pytest.mark.parametrize("sampler", ["adapter", "geo"])
def test_rp_flag_train_step_matches_jax(sampler):
    """Stage-2 region training (rp_flag): the region adapter, or the geo
    sampler, with the region adapter trainable; two steps as in
    _compare_steps."""
    cfg = jc.MedplibConfig.tiny()
    if sampler == "geo":
        cfg = dataclasses.replace(cfg, projector=dataclasses.replace(
            cfg.projector, region_geo_sampler=True))
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    assert ("region_geo_sampler" in p) == (sampler == "geo")
    p["llm"] = jlora.inject(jax.random.PRNGKey(1), p["llm"],
                            ("q_proj", "v_proj"), r=8)
    sft = jc.TrainConfig().sft_modules + ("region_geo_sampler",)
    jcfg = jc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                          lora_dropout=0.0, sft_modules=sft)
    jb, tb = _batches(cfg, 1, region=True)
    _compare_steps(cfg, p, jcfg, 1, jb, tb, rp_flag=True)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _val_batches(cfg, n, t, seed):
    out = []
    for i in range(n):
        b = ge._make_batch(cfg, B=2, T=t, rng=np.random.default_rng(seed + i))
        # a second SEG slot, invalid: only seg_valid & mask_valid count
        gt = np.concatenate([np.array(b.gt_masks)] * 2, axis=1)
        mv = np.array([[True, False], [True, True]])
        out.append(b._replace(gt_masks=jnp.asarray(gt),
                              mask_valid=jnp.asarray(mv)))
    return out


@pytest.mark.parametrize("model", ["dense", "moe_sort", "moe_gmm"])
def test_validate_matches_jax(model, tmp_path):
    """Trainer.validate on the same params and batches: gIoU, cIoU, mIoU
    and dice within 2e-3 (a pixel whose logit sits within f32 noise of
    the 0.1-sigmoid threshold may flip: one pixel of a 64 x 64 frame
    moves an IoU by ~5e-4), the mean loss 1e-5 rel. moe_gmm: 2 x 520
    tokens, so the eval capacity (2.0) covers every token and the
    dispatch is the grouped matmul (plain K3 here)."""
    if model == "dense":
        cfg = jc.MedplibConfig.tiny()
    else:
        cfg = jc.MedplibConfig.tiny(moe=jc.MoeConfig(
            enable=True, num_experts=2, top_k=1, capacity_factor=1.5,
            eval_capacity_factor=2.0))
    p = jm.init_medplib(jax.random.PRNGKey(5), cfg)
    t = 520 if model == "moe_gmm" else 16
    batches = _val_batches(cfg, 2, t, seed=40)
    jcfg = jc.TrainConfig(lora_dropout=0.0)
    jt = jtr.Trainer(cfg, jcfg, p, str(tmp_path / "j"))
    want = jt.validate(iter(batches))
    calls = []
    real = tmoe._gmm_moe

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tmoe._gmm_moe = counting
    try:
        tt = ttr.Trainer(port_cfg(cfg), port_cfg(jcfg), bridge(p),
                         str(tmp_path / "t"))
        got = tt.validate(iter([torch_batch(b) for b in batches]))
    finally:
        tmoe._gmm_moe = real
    assert set(got) == set(want) == {"giou", "ciou", "miou", "dice", "loss"}
    for k in ("giou", "ciou", "miou", "dice"):
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert 0 < got["giou"] < 1
    assert len(calls) == (2 * cfg.llm.num_layers if model == "moe_gmm"
                          else 0)


def test_fit_validates_resumes_and_logs_val(tmp_path, capsys):
    """fit(val_batches_fn=): a checkpoint and a validation pass after the
    epoch, val/ scalars in the log; a second Trainer resumes at the end
    (nothing left to train: no pass) and its validate() of the restored
    params prints the same numbers."""
    cfg, p = _moe_model()
    pc = port_cfg(cfg)
    _, tb = _batches(cfg, 1)
    vb = [torch_batch(b) for b in _val_batches(cfg, 1, 16, seed=50)]
    tcfg = tc.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, epochs=1,
                          steps_per_epoch=2, save_steps=5, log_steps=1,
                          lora_dropout=0.05)
    t = ttr.Trainer(pc, tcfg, bridge(p), str(tmp_path))
    assert t.fit(lambda: iter([tb] * 2), val_batches_fn=lambda: iter(vb)) == 2
    first = capsys.readouterr().out
    assert "epoch 0 val: giou=" in first
    assert t.ckpt.latest_step() == 2
    log = (tmp_path / "scalars.jsonl").read_text()
    for k in ("val/giou", "val/ciou", "val/miou", "val/dice", "val/loss"):
        assert f'"{k}"' in log
    t2 = ttr.Trainer(pc, tcfg, bridge(p), str(tmp_path))
    assert t2.fit(lambda: iter([tb] * 2), val_batches_fn=lambda: iter(vb)) \
        == 2
    assert t2.state.step == 2
    assert "val:" not in capsys.readouterr().out    # nothing left to train
    res = t2.validate(iter(vb))
    assert first.strip().splitlines()[-1] == (
        f"epoch 0 val: giou={res['giou']:.4f} ciou={res['ciou']:.4f} "
        f"dice={res['dice']:.4f} loss={res['loss']:.4f}")


# ---------------------------------------------------------------------------
# expert surgery
# ---------------------------------------------------------------------------

def test_build_experts_from_donors_matches_jax():
    """Two donor MLP stacks -> [L, E, in, out] kernels, leaf-equal to
    JAX's, in new buffers."""
    rng = np.random.default_rng(9)
    donors = [{n: {"kernel": rng.normal(size=(3, 8, 12) if n != "down_proj"
                                        else (3, 12, 8)).astype(np.float32)}
               for n in ("gate_proj", "up_proj", "down_proj")}
              for _ in range(2)]
    want = jml.build_experts_from_donors(donors)
    tdon = [convert.tree_from_numpy(d, device="cpu") for d in donors]
    got = tml.build_experts_from_donors(tdon)
    for n in want:
        k = got[n]["kernel"]
        assert tuple(k.shape) == want[n]["kernel"].shape
        np.testing.assert_array_equal(k.numpy(), want[n]["kernel"])
        assert k.data_ptr() != tdon[0][n]["kernel"].data_ptr()
