#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (medplib_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from medplib_tpu_torch/csrc with nvcc.
3. Kernel phases: each kernel at the flagship shapes, in A8 and bf16-x
   modes, against its plain PyTorch version on the same card (TF32 off),
   with the tolerance stated; both timed with CUDA events.
4. Small-input check: the slice at a tiny width on the card (kernels)
   against the same slice on the CPU (plain versions).
5. Main path: MedPLIB-7b-2e at full width (32 layers x 2 experts, int8
   attention / lm_head / projector, int4h experts), random weights from a
   seed, answering a batch of 16 grounding requests (T_in=48, 10 new
   tokens, W8A8 / W4A8 prefill) and one single request; checks the launch
   counts of each kernel, the outputs, and repeatability; prints masks/s
   and peak memory.

Any failed phase raises; the last stdout line, printed only on success, is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, warmup: int = 2, iters: int = 5) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def within_one_bf16_ulp(a, b) -> bool:
    """|a - b| <= 2^-7 |b| elementwise: at most one bf16 ulp apart."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= b.abs() * 2.0 ** -7).all())


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def _random_int4h(gen, e, k, n, dev):
    import torch
    packed = torch.randint(-128, 128, (e, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
    scale = torch.rand((e, 2, 1, n), generator=gen, device=dev) * 0.01 + 1e-3
    return packed, scale


def k1_phase(gen, dev, results):
    """gmm_int4h at the flagship prefill: S = 16 x 623 rows top-1 routed
    over 2 experts, two-ended aligned to Sp = 10752 (bm 512), gate/up
    (K 4096 -> N 11264) and down (K 11264 -> N 4096)."""
    import torch
    from medplib_tpu_torch.ops.cuda import gmm as G
    s, bm = 16 * 623, 512
    idx = torch.randint(0, 2, (s,), generator=gen, device=dev)
    for name, k, n in (("gate/up", 4096, 11264), ("down", 11264, 4096)):
        packed, scale = _random_int4h(gen, 2, k, n, dev)
        xs = torch.randn((s, k), generator=gen, device=dev).to(torch.bfloat16)
        x_al, _, tile_gid = G.align_groups(xs, idx, 2, bm)
        assert int(tile_gid.min()) == 0 and int(tile_gid.max()) == 1
        xq, xsc = G.quantize_rows(x_al)
        for mode, xin, a_s in (("A8", xq, xsc), ("bf16", x_al, None)):
            got = G.gmm_int4h(xin, packed, scale, tile_gid, a_s, bm)
            want = G.gmm_int4h_plain(xin, packed, scale, tile_gid, a_s, bm)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            rel = rel_err(got, want)
            if mode == "A8":
                # integer sums are exact on both sides; the epilogue is the
                # same rounded f32 ops -> equal up to one bf16 ulp
                ok, tol = within_one_bf16_ulp(got, want), "<= 1 bf16 ulp"
            else:
                # f32 sums over K in another order
                ok, tol = rel <= 1e-4, "rel Frobenius <= 1e-4"
            ms = cuda_time(lambda: G.gmm_int4h(xin, packed, scale, tile_gid,
                                               a_s, bm))
            pms = cuda_time(lambda: G.gmm_int4h_plain(xin, packed, scale,
                                                      tile_gid, a_s, bm))
            log(f"[K1 gmm_int4h {name} {mode}] Sp={x_al.shape[0]} K={k} "
                f"N={n}: max_abs_err={err:.3e} rel={rel:.3e} ({tol}) "
                f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
            if not ok:
                raise AssertionError(f"K1 {name} {mode} disagrees with plain")
            if mode == "A8" and name == "gate/up":
                results["gmm_int4h"] = dict(max_abs_err=err, ms=ms,
                                            plain_ms=pms)


def k2_phase(gen, dev, results):
    """moe_ffn_decode_int4h at the flagship decode: B=16, H=4096,
    M=11264, 2 experts (one layer)."""
    import torch
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    b, h, m, e = 16, 4096, 11264, 2
    experts = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        packed, scale = _random_int4h(gen, e, k, n, dev)
        experts[name] = {"kernel": packed, "scale4h": scale}
    x = (torch.randn((b, h), generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    idx = torch.randint(0, e, (b,), generator=gen, device=dev).to(
        torch.int32)
    gate = torch.rand((b,), generator=gen, device=dev) * 0.5 + 0.5
    for mode, a8 in (("A8", True), ("bf16", False)):
        got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, a8)
        want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e, a8)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel = rel_err(got, want)
        # same op order on both sides; exp() may differ in the last bit,
        # which can flip a rare act-quant / bf16 rounding by one step
        ok = rel <= 1e-3
        ms = cuda_time(lambda: D.moe_ffn_decode_int4h(x, experts, idx, gate,
                                                      e, a8), iters=20)
        pms = cuda_time(lambda: D.moe_ffn_decode_int4h_plain(
            x, experts, idx, gate, e, a8), iters=5)
        log(f"[K2 moe_ffn_decode_int4h {mode}] B={b} H={h} M={m}: "
            f"max_abs_err={err:.3e} rel={rel:.3e} (rel Frobenius <= 1e-3) "
            f"kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if not ok:
            raise AssertionError(f"K2 {mode} disagrees with plain")
        if mode == "A8":
            results["moe_ffn_decode_int4h"] = dict(max_abs_err=err, ms=ms,
                                                   plain_ms=pms)


# ---------------------------------------------------------------------------
# model set-up
# ---------------------------------------------------------------------------

def make_batch(cfg, b, t, rng, dev):
    """The bench batch (__graft_entry__._make_batch): random ids with BOS,
    an <image> sentinel at 2 and <SEG> at T-3; CLIP pixels N(0,1); SAM
    pixels raw 0..255 floats."""
    import torch
    from medplib_tpu_torch.config import IMAGE_TOKEN_INDEX
    from medplib_tpu_torch.models.medplib import Batch
    ids = rng.integers(3, min(cfg.llm.vocab_size, cfg.seg_token_idx),
                       size=(b, t))
    ids[:, 0] = 1
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids[:, t - 3] = cfg.seg_token_idx
    vs, ss = cfg.vision.image_size, cfg.sam.image_size
    labels = ids.copy()
    labels[:, : t // 2] = -100
    clip_px = rng.normal(size=(b, 1, vs, vs, 3)).astype(np.float32)
    sam_px = rng.uniform(0, 255, size=(b, ss, ss, 3)).astype(np.float32)
    td = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return Batch(
        input_ids=td(ids), input_mask=td(np.ones((b, t), np.int32)),
        labels=td(labels), images_clip=td(clip_px), images_sam=td(sam_px),
        image_token_lengths=td(np.full((b, 1), cfg.vision.num_patches,
                                       np.int32)))


def init_flagship(cfg, gen, dev):
    """Random MedPLIB-7b-2e in its serving quantization, built the way
    _init_flagship_moe_quantized builds it: a bf16 dense skeleton without
    the dense MLP, int8-quantized; then the experts initialized, padded
    (M 11008 -> 11264) and int4h-quantized ONE LAYER AT A TIME, so the bf16
    expert stacks never exist whole."""
    import torch
    from medplib_tpu_torch.config import MoeConfig
    from medplib_tpu_torch.models import medplib, moe_llama
    from medplib_tpu_torch.ops.initializers import normal
    from medplib_tpu_torch.utils import quantize as qz

    bf = torch.bfloat16
    params = medplib.init_medplib(
        gen, dataclasses.replace(cfg, moe=MoeConfig()), bf, dev)
    params["llm"] = moe_llama.strip_dense_mlp(params["llm"], cfg.llm,
                                              cfg.moe)
    params = qz.quantize_tree(params, bits=8)
    L, E = cfg.llm.num_layers, cfg.moe.num_experts
    H, M = cfg.llm.hidden_size, cfg.llm.intermediate_size
    nodes = {n: {"kernel": [], "scale4h": []}
             for n in ("gate_proj", "up_proj", "down_proj")}
    for _ in range(L):
        one = moe_llama.init_experts(gen, cfg.llm, cfg.moe, bf, dev)
        one = qz.pad_moe_experts_for_gmm(one)
        one = qz.quantize_tree(one, skip=(), bits=4, int4_groups=2)
        for n in nodes:
            for k in ("kernel", "scale4h"):
                nodes[n][k].append(one[n][k])
    experts = {n: {k: torch.stack(v) for k, v in node.items()}
               for n, node in nodes.items()}
    params["llm"]["layers"]["moe"] = {
        "router": {"kernel": normal(gen, (L, H, E), bf, dev, H ** -0.5)},
        "experts": experts}
    return params


# ---------------------------------------------------------------------------
# small-input check: the slice on the card against the slice on the CPU
# ---------------------------------------------------------------------------

def small_check(dev):
    import torch
    from medplib_tpu_torch import config as C
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops.cuda.gmm import gmm_int4h
    from medplib_tpu_torch.ops.cuda.moe_decode import moe_ffn_decode_int4h
    from medplib_tpu_torch.utils.convert import tree_to_numpy, tree_from_numpy
    from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                                  quantize_flagship_moe)
    llm = C.LlamaConfig(vocab_size=512, hidden_size=512,
                        intermediate_size=1024, num_layers=2, num_heads=8,
                        num_kv_heads=8, head_dim=64)
    cfg = C.MedplibConfig(
        llm=llm,
        vision=C.ClipVisionConfig(image_size=56, patch_size=14,
                                  hidden_size=64, intermediate_size=128,
                                  num_layers=3, num_heads=4),
        sam=C.SamConfig(image_size=64, patch_size=16, encoder_embed_dim=64,
                        encoder_depth=2, encoder_num_heads=2,
                        encoder_global_attn_indexes=(1,), window_size=2,
                        prompt_embed_dim=32, mask_in_chans=4,
                        decoder_mlp_dim=64, decoder_num_heads=2,
                        iou_head_hidden_dim=32),
        projector=C.ProjectorConfig(mm_hidden_size=64, hidden_size=512),
        moe=C.MoeConfig(enable=True, num_experts=2, top_k=1),
        seg=C.SegConfig(out_dim=32), seg_token_idx=500, vocab_size_padded=512)
    gen = torch.Generator().manual_seed(1)
    p = medplib.init_medplib(gen, cfg, torch.float32, "cpu")
    # unit-scale embeddings: a well-conditioned residual stream, so that
    # last-bit differences do not flip greedy tokens
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    p = tree_to_numpy(quantize_flagship_moe(p, 4, 8))
    out = {}
    for where in ("cpu", dev):
        b = make_batch(cfg, 16, 64, np.random.default_rng(0), where)
        k1, k2 = gmm_int4h.launches, moe_ffn_decode_int4h.launches
        with dynamic_act_quant(True):
            r = medplib.generate(tree_from_numpy(p, where), cfg, b,
                                 max_new_tokens=4)
        out[str(where)] = (r, gmm_int4h.launches - k1,
                           moe_ffn_decode_int4h.launches - k2)
    (rc, _, _), (rg, n1, n2) = out["cpu"], out[str(dev)]
    same = float((rc.output_ids == rg.output_ids.cpu()).float().mean())
    mrel = rel_err(rg.pred_masks.cpu(), rc.pred_masks)
    log(f"[small check] B=16 T_in=64 tiny slice, card vs CPU plain: tokens "
        f"equal {same * 100:.1f}%, mask rel err {mrel:.3e} "
        f"(K1 launches {n1}, K2 launches {n2})")
    # last-bit differences between the card's and the CPU's float sums can
    # flip a rare act-quant rounding; require near-total agreement
    if same < 0.9 or mrel > 5e-2 or n1 != 6 or n2 != 8:
        raise AssertionError("small-input slice disagrees with the CPU")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def main_path(dev, results, card):
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops.cuda.gmm import gmm_int4h
    from medplib_tpu_torch.ops.cuda.moe_decode import moe_ffn_decode_int4h
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant

    cfg = flagship_cfg(32, moe=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    params = init_flagship(cfg, gen, dev)
    torch.cuda.synchronize()
    log(f"[main] flagship initialized + quantized in {time.time() - t0:.1f} s"
        f"; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, T, NEW = 16, 48, 10
    batch = make_batch(cfg, B, T, np.random.default_rng(0), dev)
    single = make_batch(cfg, 1, T, np.random.default_rng(1), dev)
    L = cfg.llm.num_layers

    def run(b):
        with dynamic_act_quant(True):
            r = medplib.generate(params, cfg, b, max_new_tokens=NEW)
        torch.cuda.synchronize()
        return r

    def check(r, b):
        assert r.output_ids.shape == (b, NEW)
        assert int(r.output_ids.min()) >= 0
        assert int(r.output_ids.max()) < cfg.vocab_size_padded
        assert tuple(r.pred_masks.shape) == (b, 1, 256, 256)
        assert bool(torch.isfinite(r.pred_masks.float()).all())

    torch.cuda.reset_peak_memory_stats()
    gmm_int4h.launches = 0
    moe_ffn_decode_int4h.launches = 0
    t0 = time.time()
    first = run(batch)
    t_first = time.time() - t0
    k1, k2 = gmm_int4h.launches, moe_ffn_decode_int4h.launches
    check(first, B)
    log(f"[main] batch B={B}: first call {t_first:.2f} s; launches "
        f"gmm_int4h={k1} (want {3 * L}), moe_ffn_decode_int4h={k2} "
        f"(want {L * NEW}); has_seg {first.has_seg.sum().item()}/{B}")
    if k1 != 3 * L or k2 != L * NEW:
        raise AssertionError("main path did not run the kernels as expected")
    results["gmm_int4h"]["launches"] = k1
    results["moe_ffn_decode_int4h"]["launches"] = k2

    times = []
    for _ in range(3):
        t0 = time.time()
        r = run(batch)
        times.append(time.time() - t0)
    if not torch.equal(r.output_ids, first.output_ids):
        raise AssertionError("a repeated batch call gave other tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = sum(times) / len(times)
    log(f"[main] batch B={B} T_in={T} max_new={NEW}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s per call -> "
        f"{B / dt:.3f} masks/s; peak allocated {peak:.2f} GiB on {card}")

    c1, c2 = gmm_int4h.launches, moe_ffn_decode_int4h.launches
    t0 = time.time()
    one = run(single)
    t_one = time.time() - t0
    check(one, 1)
    d1, d2 = gmm_int4h.launches - c1, moe_ffn_decode_int4h.launches - c2
    log(f"[main] single request B=1: {t_one:.3f} s; launches "
        f"gmm_int4h={d1} (want 0, sort prefill), "
        f"moe_ffn_decode_int4h={d2} (want {L * NEW})")
    if d1 != 0 or d2 != L * NEW:
        raise AssertionError("single request did not take the expected path")
    return B / dt, peak


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from medplib_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; TF32 off (matmul and cuDNN)")

    t0 = time.time()
    _build.load_library()
    log(f"[build] {time.time() - t0:.1f} s -> {_build.library_path()}\n"
        f"{_build.build_log.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    k1_phase(gen, dev, results)
    k2_phase(gen, dev, results)
    torch.cuda.empty_cache()
    small_check(dev)
    masks_per_s, peak = main_path(dev, results, card)

    meta = {
        "gmm_int4h": ("medplib_tpu_torch/csrc/gmm_int4h.cu",
                      "medplib_tpu/ops/pallas/gmm.py:348"),
        "moe_ffn_decode_int4h": ("medplib_tpu_torch/csrc/moe_decode_int4h.cu",
                                 "medplib_tpu/ops/pallas/moe_decode.py:258"),
    }
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=results[n]["launches"],
                    max_abs_err=results[n]["max_abs_err"],
                    ms=results[n]["ms"], plain_ms=results[n]["plain_ms"])
               for n, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[result] {masks_per_s:.3f} masks/s, peak {peak:.2f} GiB, "
          f"{card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
