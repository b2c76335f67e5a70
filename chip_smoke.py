#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (medplib_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profiles              (also the profiled calls
                                                   no PERF.md metric reads)
    python3 chip_smoke.py --k2-equal-share ROOT   (K2 alone, see
                                                   k2_equal_share)
    python3 chip_smoke.py --icl-profile ROOT      (ICL config 5 alone, see
                                                   icl_profile)
    python3 chip_smoke.py --stage4-step ROOT [LAYERS]  (stage-4 steps
                                                   alone, see stage4_step)

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from medplib_tpu_torch/csrc with nvcc
   and counts, with cuobjdump, the tensor-core instructions of each
   instance of the tensor-core kernels (HMMA: K7 on bf16 x, K3 int8-w /
   bf16, K9 and K1 on bf16 x, K2 on bf16 x, K4 / K5 / K6 on bf16; IMMA:
   K8, K3 W8A8, K1 W4A8, K2 A8).
3. Kernel phases: each kernel at the shapes its main path gives it (K1,
   K2 in A8 and bf16-x modes at the flagship serving shapes, K2 also at
   block_n 128 / 256 / 512, at B=80 rows and with 6 of 64 experts a row
   at DeepSeek-V2-Lite's decode (B=64, H=2048, M=1536); K3 in W8A8 at the int8-expert flagship shapes, int8-w and
   float bf16 at the ICL shapes, transposed at a small shape; K7
   int8_matmul and K9 int4h_matmul at the packed dense serving shapes,
   prefill and decode, both layouts; K8 w8a8_matmul, on no path, at the
   dense W8A8 shapes; K4, K5, K6 at the stage-3 training shape, K4 also
   at the ICL shape and at the serving prefill's, including its <192,
   128> instantiation at DeepSeek-V2-Lite's B=64 x 623-687) against
   its plain PyTorch version on the same card (TF32 off), with the
   tolerance stated; timed with CUDA events beside the plain version, the
   least time the card could take (bound_ms) and a library yardstick
   (SDPA for flash attention; torch._grouped_mm or per-expert torch calls
   for K3 and K1, per-expert torch._int_mm on a row-major and a
   column-major weight for K3 W8A8 and K1 A8; torch.matmul on a bf16
   weight dequantized beforehand for K7 / K9; torch._int_mm for K8, both
   weight layouts). Then one call per wrapper at odd widths (N = 320, K =
   688) and a head_dim-256 prompt, which takes the plain attention.
4. Small-input checks, card (kernels) against CPU (plain versions): the
   generate slice at a tiny width with int4h experts (K1, K2), with int8
   experts and the int8 KV cache (K3), and over a packed dense tree in
   int8 under W8A8 (K7) and in int4h (K9); region VQA with the region
   adapter and with the geo sampler, the ICL compressor with the mask
   encoder, and sampled decode from the same per-row seeds (equal stream
   keys on both); the geo sampler's point, FPS and kNN indices at full
   width (1024-d features, 24 x 24 masks, B·M = 16), which must be
   equal; two QLoRA train steps of a tiny model with head_dim 128 and
   a 1039-token spliced row (flash route), and two of its stage-4 form
   (sparse Residual-MoE, top-1 at capacity 1.5, a skewed router that
   drops tokens); the training CLI (train/cli.py --tiny --moe-enable,
   experts from two donor directories) for two steps with validation and
   then --eval-only, in process on the card; and the serving engine
   (serve/engine.BatchedEngine) on the tiny int4h MoE model, 4 slots, 8
   grouped requests with 256-token prefill chunks (K1 at a 1024-row
   extend, K2 at decode): equal tokens, masks from Request.ground(); and
   the serving worker on that model with the region adapter
   (small_worker_check): greedy, <SEG>, region and seeded sampled
   requests as PNG payloads, equal texts, masks within 1% of pixels;
   the tiny export pipeline (LoRA q / v merged, quantized, served: K1,
   K2) and a tiny ALiBi MPT, each card vs CPU.
5. Serving main paths, MedPLIB-7b-2e at full width (32 layers x 2
   experts, int8 attention / lm_head / projector), random weights from a
   seed: with int4h experts, a batch of 16 grounding requests (T_in=48,
   10 new tokens, W8A8 / W4A8 prefill; K1 = 96, K2 = 320, K4 = 32
   launches: every prefill at head_dim 128 takes flash, once a layer),
   one profiled call and one single request (K2, K4); then the serving
   engine on the same tree (engine_path): E1, run_all.py config 8 with
   BENCH_ENGINE_MOE=1 (12 slots, 24 greedy requests of 32 tokens, int8
   KV, per-request admission: K2, K4 32 a prefill; run twice, equal
   tokens; first tokens equal to a B=1 stream_prefill; two <SEG>
   requests grounded),
   E2, the same with group_admission and 256-token prefill chunks (K1 on
   bf16 x at each 4096-row extend), E3, config 10's traffic (8 slots, 7
   background streams of 512 tokens, 12 probes: TTFT and the background
   stall), every launch count checked against the decode steps and
   extends the engine dispatched, and one profiled decode chunk; then the
   serving front end on the same tree (worker_path): W1, the port's
   controller, a ModelWorker (12 slots, int8 KV) and the web UI on
   loopback HTTP, 24 requests with 512 x 640 PNG images, 12 at a time,
   through web /generate and again straight to the worker's stream (K1
   0, K2 32 per decode step, K4 32 per prefill; texts repeat; a <SEG>
   mask in the image's frame; host preprocessing per image and a
   cProfile of one request),
   and W2, the sequential worker on two of them. Then evaluation and
   retrieval on the same tree (eval_path): 32 seeded 512 x 384 PNGs with
   masks, Evaluator.run in seg and vqa mode (24 samples, B=16, the last
   batch padded, 10 new tokens, act quant off: K1 on bf16 x 96, K2
   320 and K4 32 per generate call, every record equal to a direct
   generate call), capture_router_logits on one B=16 batch (K1 96, K4
   32; the per-layer expert load), the CLIP retrieval index (each query
   retrieves itself first), SamPredictor.predict card vs CPU in f32 and
   generate_masks (16 x 16 points, one crop layer, the small-region
   cleanup, COCO RLE). With int8 experts, a batch of 8 (int8 KV cache,
   W8A8 prefill; K3 = 96, K4 = 32 launches), one profiled call and a
   single request (K4 32, no K3), then ICL config 5 on the same tree
   (B=4, three images per row, 1789 spliced tokens, no activation quant;
   K3 = 96, K4 = 32, one profiled call).
   Released checkpoint -> sampled region VQA (region_path): the bf16
   flagship with the 576 -> 256 compressor and the region adapter turned
   into a released-layout state dict (utils/hf_export.medplib_to_hf) and
   loaded back (utils/export.load_reference_checkpoint), leaf for leaf
   equal; run_all.py config 3 on it (B=2, region marker, compressor,
   ground=False, 16 new tokens; K4 32 alone: sort prefill, no fused
   decode for bf16 experts); then the tree
   quantized for serving (int4h experts) and a batch of 16 region
   requests, half sampled from per-row seeds, half greedy (K1 = 96, K2 =
   320, one profiled call; repeat calls equal, other seeds move only
   sampled rows) and one request (K2 = 320); K4 = 32 in each.
   Then packed dense serving (the dense MedPLIB-7B, pack_inference): int8
   B=16 under W8A8 (K7 = 704) and int4h B=12 (K9 = 704), K4 32 a call,
   each with one profiled call and a single request after it. Then the
   stage-3 QLoRA train step (dense 7B, K4 64, K5 32, K6 32 a step), and stage 4
   (moe_train_phase): the MedPLIB-7b-2e bf16 tree with its experts from
   two donor stacks, LoRA q/v, B=4 x 1087 tokens x ga 8 (K4 512, K5 256,
   K6 256 a step), then Trainer.validate over two B=4 batches (K3 96 in
   its bf16 float mode and K4 32 a batch). Then the export path
   (export_path) on that trained tree: merge_lora (each merged q / v
   element within bf16 rounding of its f32 value; teacher-forced logits
   of the merged tree against the unmerged tree's), the file tools and
   `python -m medplib_tpu_torch.utils.export` on its first 2 layers
   (inspect, to-f32, to-hf in >= 2 shards, from-reference back
   leaf-equal, make_delta / apply_delta, consolidate), export_seg_decoder
   at B=16 run through torch.export.load, the int4 block scheme at 4096
   x 11008 card vs CPU, then quantize_flagship_moe and the main path's
   B=16 request on the merged tree (K1 96, K2 320, K4 32). Last, MPT-7B
   (mpt_path: 4096 x 32 layers, ALiBi, bf16 from a seed) greedy at B=4,
   64 prompt tokens, 16 new; no kernel launches there.
   Distribution and the opt-in modules: two gloo rank processes
   sharing the card (started after the build, params and batches through
   CUDA IPC): after the main path, on its tree (dist_serving): EP = 2
   (mesh (1, 2, 1), ep_shard: K1 96 a rank at prefill and at every decode
   step, no K2; K4 32 a rank a prefill) generate and the streaming
   entry points, equal to one process whose decode keeps the three K1
   calls (K2's eligibility patched off in ops/moe); TP = 2 (mesh (1, 1,
   2)) equal to the main path's call (K1 96, K2 320, K4 32 a rank); NCCL
   at world size 1 (the main path's call under a (1, 1, 1) mesh, equal);
   then opt_in_path: the ragged dispatch against gmm on one MoE layer,
   the worker's device_preprocess on the 24 front-end PNGs, the native
   preprocessing library against numpy. After the stage-3 and stage-4
   phases, DP = 2 (mesh (2, 1, 1)) steps against one
   process's (dist_train_stage3 on train_phase's tree at B=8 x 1087,
   dist_train_stage4 on the trained tree's first 2 layers with a skewed
   router: equal drops). No speed is claimed for the two ranks.
   Each path runs with every launch count set to 0 just before it and
   read just after; each checks the outputs and repeatability and prints
   masks/s or ms/sample and peak memory. Only the main path's and the
   engine's decode-chunk profiles run by default; --profiles adds the
   others.
Any failed phase raises; the line before the last is the card's name and
power limit, the last stdout line, printed only on success, is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import gc
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


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def sass_phase(lib_path, build_log: str) -> None:
    """cuobjdump --dump-sass of the built library: the tensor-core
    instructions in each instance of the tensor-core kernels (HMMA in
    w8_mma_kernel: K7 on bf16 x, K3 int8-w / bf16; int4h_mma_kernel: K9 on
    bf16 x (int4_matmul.cu, 8 instances) and K1 on float x (gmm_int4h.cu,
    2); flash_fwd_mma_kernel (2: MLA's <192, 128>), flash_dq_mma_kernel and
    flash_dkv_mma_kernel: K4, K5 and K6 on bf16; moe_gateup_kernel and
    moe_down_kernel<false>: K2 on bf16 x; IMMA in s8_mma_kernel: K8
    (int8_matmul.cu, 4 instances), K3 W8A8 (gmm.cu, 4) and K1 W4A8
    (gmm_int4h.cu, 2); moe_gateup_kernel and moe_down_kernel<true>: K2
    A8) and, for contrast, in the CUDA-core kernels (K3 f32 pairs, K7 f32
    x, K9 f32 x, K4 / K5 / K6 f32). Fails if a tensor-core instance holds
    none or an instance count changes.
    From this run's nvcc log (ptxas -v), each tensor-core instance's
    registers and spill stores; fails on a spill."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    fns = []     # [name, HMMA count, IMMA count] per function of each object
    for line in sass.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            fns.append([m.group(1), 0, 0])
        elif fns:
            fns[-1][1] += bool(re.search(r"\bHMMA\b", line))
            fns[-1][2] += bool(re.search(r"\bIMMA\b", line))
    hmma = {"w8_mma_kernel": 12, "int4h_mma_kernel": 10,
            "flash_fwd_mma_kernel": 2, "flash_dq_mma_kernel": 1,
            "flash_dkv_mma_kernel": 1, "moe_gateup_kernelILb0": 1,
            "moe_down_kernelILb0": 1}        # kernel -> its instances
    imma = {"s8_mma_kernel": 10, "moe_gateup_kernelILb1": 1,
            "moe_down_kernelILb1": 1}
    bad = []
    for kern, n in list(hmma.items()) + list(imma.items()):
        col = 1 if kern in hmma else 2
        got = [(f, c[col - 1]) for f, *c in fns if kern in f]
        for f, c in sorted(got):
            log(f"[sass] {c:4d} {'HMMA' if col == 1 else 'IMMA'}  {f}")
        if len(got) != n or not all(c for _, c in got):
            bad.append((kern, got))
    other = [(h, i) for f, h, i in fns
             if any(k in f for k in ("gmm_kernel", "int8_matmul_kernel",
                                     "int4h_matmul_f32_kernel",
                                     "flash_fwd_kernel", "flash_dq_kernel",
                                     "flash_dkv_kernel"))]
    log(f"[sass] CUDA-core kernels (K3 f32 pairs, K7 f32 x, K9 f32 x, "
        f"K4 / K5 / K6 f32): {sum(h for h, _ in other)} HMMA, "
        f"{sum(i for _, i in other)} IMMA in {len(other)} instances")
    if bad:
        raise AssertionError(f"tensor-core kernels without HMMA / IMMA or "
                             f"with other instance counts: {bad}")
    if not build_log:
        log("[ptxas] the library was built before this run: no ptxas lines")
        return
    regs, name = {}, None     # instance -> [registers, spill store bytes]
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in
                                     list(hmma) + list(imma)) else None
        elif name:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                regs.setdefault(name, [0, 0])[1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.setdefault(name, [0, 0])[0] = int(m.group(1))
                name = None
    for f, (r, spill) in sorted(regs.items()):
        log(f"[ptxas] {r:3d} registers, {spill} bytes spill stores  {f}")
    if len(regs) != sum(hmma.values()) + sum(imma.values()) or any(
            spill for _, spill in regs.values()):
        raise AssertionError("tensor-core kernels missing from the ptxas "
                             "log, or spilling")


def _random_int4h(gen, e, k, n, dev):
    import torch
    packed = torch.randint(-128, 128, (e, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
    scale = torch.rand((e, 2, 1, n), generator=gen, device=dev) * 0.01 + 1e-3
    return packed, scale


def k1_phase(gen, dev, results):
    """gmm_int4h at the flagship prefill: S = 16 x 623 rows top-1 routed
    over 2 experts, two-ended aligned to Sp = 10752 (bm 512), gate/up
    (K 4096 -> N 11264) and down (K 11264 -> N 4096). A8 (the s8 tensor
    cores): exact integer sums and the plain version's rounded epilogue
    in its order -> bit-equal (the equal share is printed; also with no
    a_scale and an f32 output). bf16 x (K9's bf16 tensor-core tile
    grouped by tile_gid): f32 sums in another order -> rel 1e-4.
    Yardsticks: the integer
    products alone on the nibbles widened to int8 (per-expert
    torch._int_mm, row-major and column-major weight) and, for bf16 x,
    the bf16 products on the widened nibbles (_grouped_library_ms)."""
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
                # same rounded f32 ops in the same order -> bit-equal
                ok = torch.equal(got, want)
                tol = (f"bit-equal: {ok}, "
                       f"{float((got == want).float().mean()) * 100:.4f}% "
                       f"equal")
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
            # the routed rows' products; bytes of every operand
            bms, by = bound(nbytes(xin, packed, scale, tile_gid, got) + (
                nbytes(a_s) if a_s is not None else 0), 2 * s * k * n,
                INT8_OPS if mode == "A8" else BF16_FLOPS)
            # yardstick: the products alone, on the nibbles widened to
            # int8 (A8) or bf16
            wide = G.unpack_pairs(packed)
            lib_ms, lib = _grouped_library_ms(
                xin, wide if mode == "A8" else wide.to(torch.bfloat16),
                tile_gid, bm)
            log(f"[K1 gmm_int4h {name} {mode}] {2 * s * k * n / ms / 1e9:.1f}"
                f" T{'OP' if mode == 'A8' else 'FLOP'}/s of the routed rows' "
                f"products, bound {bms:.4f} ms "
                f"({by}), {lib} on the widened nibbles {lib_ms:.3f} ms "
                f"({ms / lib_ms:.2f}x)")
            del wide
            if mode == "A8":
                # the reference's defaults: no a_scale (ones), f32 output
                got = G.gmm_int4h(xin, packed, scale, tile_gid, None, bm,
                                  out_dtype=torch.float32)
                want = G.gmm_int4h_plain(xin, packed, scale, tile_gid, None,
                                         bm, out_dtype=torch.float32)
                torch.cuda.synchronize()
                log(f"[K1 gmm_int4h {name} A8] a_scale None, f32 out: "
                    f"bit-equal {torch.equal(got, want)}")
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 {name} A8 f32 out disagrees")
                del got, want
            if mode == "A8" and name == "gate/up":
                results["gmm_int4h"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)


def _k2_rows(gen, dev, b, h=4096, e=2):
    """b decode rows of width h routed over e experts."""
    import torch
    x = (torch.randn((b, h), generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    idx = torch.randint(0, e, (b,), generator=gen, device=dev).to(
        torch.int32)
    gate = torch.rand((b,), generator=gen, device=dev) * 0.5 + 0.5
    return x, idx, gate


def _k2_inputs(gen, dev, b, h=4096, m=11264, e=2):
    """One layer of random int4h experts at the flagship decode widths and
    b rows routed over them."""
    experts = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        packed, scale = _random_int4h(gen, e, k, n, dev)
        experts[name] = {"kernel": packed, "scale4h": scale}
    return (experts,) + _k2_rows(gen, dev, b, h, e)


def k2_phase(gen, dev, results):
    """moe_ffn_decode_int4h at the flagship decode: B=16, H=4096,
    M=11264, 2 experts (one layer), A8 and bf16 x at the default block_n
    (512), A8 also at block_n 128 / 256 / 512, then B=80 (two counted
    launches). Each against its plain version at rel Frobenius 1e-3, with
    the share of bit-equal elements printed. Then k2_topk_case (k experts
    a row), into the kernels line under "topk"."""
    import torch
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    b, e = 16, 2
    experts, x, idx, gate = _k2_inputs(gen, dev, b)
    h, m = x.shape[1], experts["gate_proj"]["kernel"].shape[-1]
    cases = [("A8", True, None), ("bf16", False, None), ("A8", True, 128),
             ("A8", True, 256), ("A8", True, 512)]
    for mode, a8, bn in cases:
        kw = dict(block_n=bn, int8_x=a8)
        got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, **kw)
        want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel = rel_err(got, want)
        equal = float((got == want).float().mean()) * 100
        # same op order on both sides; exp() may differ in the last bit,
        # which can flip a rare act-quant / bf16 rounding by one step
        ok = rel <= 1e-3
        ms = cuda_time(lambda: D.moe_ffn_decode_int4h(x, experts, idx, gate,
                                                      e, **kw), iters=20)
        pms = cuda_time(lambda: D.moe_ffn_decode_int4h_plain(
            x, experts, idx, gate, e, **kw), iters=5)
        log(f"[K2 moe_ffn_decode_int4h {mode}] B={b} H={h} M={m} "
            f"block_n={bn or D._pick_bn(m // 2)}: max_abs_err={err:.3e} "
            f"rel={rel:.3e} (rel Frobenius <= 1e-3), {equal:.4f}% "
            f"bit-equal; kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if not ok:
            raise AssertionError(f"K2 {mode} block_n={bn} disagrees with "
                                 f"plain")
        if mode == "A8" and bn is None:
            # the weights of the experts this batch routes to, read once
            used = [int(u) for u in torch.unique(idx).tolist()]
            wbytes = sum(nbytes(node["kernel"][used], node["scale4h"][used])
                         for node in experts.values())
            bms, by = bound(wbytes + nbytes(x, idx, gate, got),
                            2 * b * 3 * h * m, INT8_OPS)
            results["moe_ffn_decode_int4h"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None)
            log(f"[K2 moe_ffn_decode_int4h] bound {bms:.4f} ms ({by}: "
                f"{len(used)} experts' weights; {wbytes / ms / 1e6:.1f} "
                f"GB/s of them), one PyTorch call for the same function: "
                f"none (no call routes rows to int4 experts and fuses "
                f"gate / up, silu and down); its kernels over 100 calls:")
            profile_step(lambda: [D.moe_ffn_decode_int4h(
                x, experts, idx, gate, e, **kw) for _ in range(100)], top=6)
    # more than 64 rows: one launch per 64 rows
    x, idx, gate = _k2_rows(gen, dev, 80, h=h)
    n0 = D.moe_ffn_decode_int4h.launches
    got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, int8_x=True)
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e,
                                        int8_x=True)
    torch.cuda.synchronize()
    rel = rel_err(got, want)
    launches = D.moe_ffn_decode_int4h.launches - n0
    log(f"[K2 moe_ffn_decode_int4h A8] B=80: {launches} launches, "
        f"rel={rel:.3e} (rel Frobenius <= 1e-3)")
    if rel > 1e-3 or launches != 2:
        raise AssertionError("K2 at B=80 disagrees with plain")
    results["moe_ffn_decode_int4h"]["topk"] = k2_topk_case(gen, dev)


def k2_topk_case(gen, dev, b=64, h=2048, m=1536, e=64, k=6):
    """K2 with k experts a row at DeepSeek-V2-Lite's decode: B=64 rows, 6
    distinct of 64 experts each, H=2048, expert width 1408 padded to
    1536. A8 against its plain version bit for bit (the integer products
    and the combine's order are the plain version's), bf16 x at rel
    Frobenius <= 1e-3; one counted launch; A8 timed with CUDA events
    beside its plain version and its bound (the weights of the experts
    the batch routes to, read once). -> the kernels line's record."""
    import torch
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    experts = {}
    for name, (kk, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                          ("down_proj", (m, h))):
        packed, scale = _random_int4h(gen, e, kk, n, dev)
        experts[name] = {"kernel": packed, "scale4h": scale}
    x = (torch.randn((b, h), generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    idx = torch.stack([torch.randperm(e, generator=gen, device=dev)[:k]
                       for _ in range(b)]).to(torch.int32)
    gate = torch.rand((b, k), generator=gen, device=dev) * 0.2
    rec = dict(B=b, H=h, M=m, E=e, k=k)
    for mode, a8 in (("A8", True), ("bf16", False)):
        n0 = D.moe_ffn_decode_int4h.launches
        got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, int8_x=a8)
        want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e,
                                            int8_x=a8)
        torch.cuda.synchronize()
        launches = D.moe_ffn_decode_int4h.launches - n0
        rel = rel_err(got, want)
        equal = float((got == want).float().mean()) * 100
        log(f"[K2 moe_ffn_decode_int4h top-{k} {mode}] B={b} H={h} M={m} "
            f"E={e}: {launches} launch, rel={rel:.3e}, {equal:.4f}% "
            f"bit-equal (A8: bit-equal; bf16: rel Frobenius <= 1e-3)")
        ok = torch.equal(got, want) if a8 else rel <= 1e-3
        if launches != 1 or not ok:
            raise AssertionError(f"K2 top-{k} {mode} disagrees with plain")
    used = [int(u) for u in torch.unique(idx).tolist()]
    wbytes = sum(nbytes(node["kernel"][used], node["scale4h"][used])
                 for node in experts.values())
    ms = cuda_time(lambda: D.moe_ffn_decode_int4h(x, experts, idx, gate, e,
                                                  int8_x=True), iters=20)
    pms = cuda_time(lambda: D.moe_ffn_decode_int4h_plain(
        x, experts, idx, gate, e, int8_x=True), iters=3)
    bms, by = bound(wbytes + nbytes(x, idx, gate, got),
                    2 * b * k * 3 * h * m, INT8_OPS)
    log(f"[K2 moe_ffn_decode_int4h top-{k} A8] kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms, bound {bms:.4f} ms ({by}: {len(used)} experts' "
        f"weights; {100 * bms / ms:.1f}% of the bound)")
    return dict(rec, experts_used=len(used), ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=by)


# the MoE prefill's routed rows: (name, S tokens, k, E, H, M); Sp follows
# from align_rows at block_m 512. dsv2lite-ground-b64: 64 rows of 687
# (padded) tokens, top-6 of 64, expert width 1408 padded to 1536, 296,448
# aligned rows; moe-ground-b16: 16 x 687, top-1 of 2, 11,776 aligned rows
MOE_PREFILL_SHAPES = (("dsv2lite", 43968, 6, 64, 2048, 1536),
                      ("flagship", 10992, 1, 2, 4096, 11264))


def combine_order_close(got, want, y_al, dest, w):
    """Two top-k combines of the same rows that sum the k f32 products in
    other orders, each rounded once to bf16: within one bf16 step of the
    larger plus both orders' f32 summation bounds, 2 (k - 1) 2^-24 sum |p|
    (which only counts where the products cancel). -> (ok, largest error
    over its bound, share of bit-equal elements)."""
    import torch
    s, k = w.shape
    mag = (y_al[dest.long()].float().abs().reshape(s, k, -1)
           * w.float().abs()[..., None]).sum(1)
    gf, wf = got.float(), want.float()
    _, ex = torch.frexp(torch.maximum(gf.abs(), wf.abs()))
    lim = torch.ldexp(torch.ones_like(gf), ex - 8) \
        + 2 * (k - 1) * 2.0 ** -24 * mag
    worst = float(((gf - wf).abs() / lim).max())
    return worst <= 1.0, worst, float((got == want).float().mean())


def moe_prefill_phase(gen, dev, results):
    """The MoE prefill's three int8 passes (ops/cuda/moe_prefill.py) at
    the main paths' shapes (MOE_PREFILL_SHAPES): each against its plain
    version (dispatch and SwiGLU-quantize bit-equal, every aligned row;
    the top-k combine by combine_order_close, its bit-equal share
    printed), then timed with CUDA events beside its bytes bound (each
    input byte read once, each output byte written once) and its plain
    version. The top-k combine runs at the top-k shape only. The first
    shape's numbers go into the kernels line, the flagship's under
    "flagship"."""
    import torch
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_prefill as P
    for name, s, k, e, h, m in MOE_PREFILL_SHAPES:
        xs = (torch.randn((s, h), generator=gen, device=dev) * 0.5).to(
            torch.bfloat16)
        scores = torch.rand((s, e), generator=gen, device=dev)
        idx = scores.topk(k, -1).indices.reshape(-1)
        dest, _, sp = G.align_rows(idx, e, 512)
        h1, h2 = ((torch.randn((sp, m), generator=gen, device=dev) * 2.0)
                  .to(torch.bfloat16) for _ in range(2))
        cases = [("moe_dispatch_quant",
                  lambda: P.moe_dispatch_quant(xs, dest, sp, k),
                  lambda: P.moe_dispatch_quant_plain(xs, dest, sp, k),
                  nbytes(xs) + 4 * s * k + sp * h + 4 * sp),
                 ("moe_swiglu_quant", lambda: P.moe_swiglu_quant(h1, h2),
                  lambda: P.moe_swiglu_quant_plain(h1, h2),
                  nbytes(h1, h2) + sp * m + 4 * sp)]
        if k > 1:
            y_al = (torch.randn((sp, h), generator=gen, device=dev)
                    * 0.1).to(torch.bfloat16)
            w = torch.softmax(torch.randn((s, k), generator=gen,
                                          device=dev), -1)
            cases.append((
                "moe_topk_combine",
                lambda: P.moe_topk_combine(y_al, dest, w, torch.bfloat16),
                lambda: P.moe_topk_combine_plain(y_al, dest, w,
                                                 torch.bfloat16),
                2 * s * k * h + 8 * s * k + 2 * s * h))
        for kern, run, plain, by in cases:
            n0 = getattr(P, kern).launches
            got, want = run(), plain()
            torch.cuda.synchronize()
            launches = getattr(P, kern).launches - n0
            if kern == "moe_topk_combine":
                ok, worst, eq = combine_order_close(got, want, y_al, dest, w)
                err = float((got.float() - want.float()).abs().max())
                what = (f"{100 * eq:.4f}% bit-equal, largest error / bound "
                        f"{worst:.3f} (one bf16 step + the f32 sum orders' "
                        f"bounds)")
            else:
                ok = all(torch.equal(a, b) for a, b in zip(got, want))
                err = 0.0 if ok else float("nan")
                what = "bit-equal" if ok else "NOT bit-equal"
            del got, want
            ms = cuda_time(run, iters=20)
            pms = cuda_time(plain, iters=3)
            bms, bby = bound(by, 0.0, INT8_OPS)
            log(f"[{kern}] {name} S={s} k={k} E={e} H={h} M={m} Sp={sp}: "
                f"{launches} launch, {what}; kernel {ms:.3f} ms, bound "
                f"{bms:.3f} ms ({bby}: {by / 1e9:.3f} GB, "
                f"{100 * bms / ms:.1f}% of it, {by / ms / 1e6:.0f} GB/s), "
                f"plain {pms:.3f} ms")
            if launches != 1 or not ok:
                raise AssertionError(f"{kern} disagrees with its plain "
                                     f"version at the {name} shape")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                       bound_by=bby, library_ms=None, S=s, k=k, Sp=sp)
            if name == "flagship":
                results[kern]["flagship"] = rec
            else:
                results[kern] = rec
        del xs, h1, h2
        torch.cuda.empty_cache()


def k2_equal_share(root: str) -> None:
    """`--k2-equal-share ROOT`: K2 in A8 at the flagship decode (B=16,
    the default block_n) on inputs from seed 0, from the
    package under ROOT (this checkout, or another commit's unpacked
    tree): the share of elements bit-equal to its plain version, and its
    time. Run for two trees in one call to compare their kernels."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from medplib_tpu_torch.ops.cuda import _build
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    experts, x, idx, gate = _k2_inputs(gen, dev, 16)
    got = D.moe_ffn_decode_int4h(x, experts, idx, gate, 2, int8_x=True)
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, 2,
                                        int8_x=True)
    torch.cuda.synchronize()
    ms = cuda_time(lambda: D.moe_ffn_decode_int4h(x, experts, idx, gate, 2,
                                                  int8_x=True), iters=20)
    log(f"[K2 equal share] {D.__file__}: "
        f"{float((got == want).float().mean()) * 100:.4f}% bit-equal, "
        f"rel={rel_err(got, want):.3e}, kernel {ms:.3f} ms; {gpu_line()}")


def icl_profile(root: str) -> None:
    """`--icl-profile ROOT`: ICL config 5 (the int8-expert flagship with
    icl_enable, B=4, three images per row, 10 new tokens) from the package
    under ROOT: the tokens' sum, one host-clock call after a warm one and
    one profiled call. A short call of its own cross-checks the profile
    that int8_path takes late in the long run; run it for two trees in one
    call to compare them."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops.cuda import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(flagship_cfg(32, moe=True), icl_enable=True)
    params = init_flagship(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev, expert_bits=8)
    batch = make_icl_batch(cfg, 4, 64, np.random.default_rng(0), dev)

    def run():
        r = medplib.generate(params, cfg, batch, max_new_tokens=10)
        torch.cuda.synchronize()
        return r

    first = run()
    t0 = time.time()
    run()
    log(f"[ICL profile] {medplib.__file__}: tokens sum "
        f"{int(first.output_ids.sum())}, {time.time() - t0:.3f} s a call; "
        f"{gpu_line()}")
    profile_step(run, top=6, always=True)


def stage4_step(root: str, layers: int = 8) -> None:
    """`--stage4-step ROOT [LAYERS]`: stage-4 training steps from the
    package under ROOT (this checkout, or another commit's unpacked tree):
    moe_train_phase's model and batch (MedPLIB-7b-2e at full width, its
    first LAYERS layers, top-1 at capacity 1.5 through the sort dispatch,
    LoRA q / v, B=4 x 1087 tokens x ga 8), one warm-up step and five timed
    ones (host clock ending in a synchronize), and each step's loss. Run it
    for two trees in one call to compare their steps."""
    import shutil
    import tempfile

    import torch
    sys.path.insert(0, os.path.abspath(root))
    from medplib_tpu_torch.config import TrainConfig, flagship_cfg
    from medplib_tpu_torch.models.medplib import Batch
    from medplib_tpu_torch.ops import moe
    from medplib_tpu_torch.ops.cuda import _build
    from medplib_tpu_torch.train import lora, trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    dev = torch.device("cuda", 0)
    cfg = flagship_cfg(layers, moe=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_stage4(cfg, gen, dev)
    params["llm"] = lora.inject(gen, params["llm"], ("q_proj", "v_proj"),
                                r=8)
    B, T, GA = 4, 512, 8
    rng = np.random.default_rng(0)
    micro = [make_batch(cfg, B, T, rng, dev) for _ in range(GA)]
    batches = Batch(*[torch.stack(xs) for xs in zip(*micro)])
    del micro
    tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=100,
                       grad_accumulation_steps=GA, lora_dropout=0.05)
    log_dir = tempfile.mkdtemp(prefix="stage4_step_")
    try:
        tr = trainer.Trainer(cfg, tcfg, params, log_dir)
        del params
        times, losses = [], []
        for _ in range(6):
            t0 = time.time()
            tr.state, m = tr.step_fn(tr.state, batches)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.time() - t0)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    timed = times[1:]
    log(f"[stage-4 step] {moe.__file__}: {layers} layers, B={B} x ga {GA}:"
        f" warm-up {times[0]:.3f} s, steps "
        f"{', '.join(f'{t:.3f}' for t in timed)} s (mean "
        f"{sum(timed) / len(timed):.3f}, min {min(timed):.3f}); losses "
        f"{losses}; {gpu_line()}")


def _grouped_library_ms(xin, w, tile_gid, bm):
    """The library yardstick for one grouped matmul over an aligned
    buffer, w [E, K, N]: torch._grouped_mm (one call) for bf16 operands
    where the installed torch has it; else the sum of one torch call per
    expert over its contiguous tiles: for int8 x torch._int_mm, timed on
    the row-major [K, N] expert weight and on the same weight
    column-major, the faster of the two taken (both in the label); else
    torch.matmul on the bf16-cast weight. -> (ms, label)."""
    import torch
    gid = tile_gid.long()
    ends = [int((gid <= g).sum()) * bm for g in range(w.shape[0])]
    if xin.dtype == torch.bfloat16 and w.dtype == torch.bfloat16 and \
            hasattr(torch, "_grouped_mm"):
        offs = torch.tensor(ends, dtype=torch.int32, device=xin.device)
        wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
        return cuda_time(lambda: torch._grouped_mm(xin, wt, offs=offs)), \
            "torch._grouped_mm"
    starts = [0] + ends[:-1]
    spans = [(g, a, b) for g, (a, b) in enumerate(zip(starts, ends)) if b > a]
    if xin.dtype == torch.int8:
        w_row = w.contiguous()
        w_col = w.transpose(-2, -1).contiguous().transpose(-2, -1)
        row, col = (sum(cuda_time(lambda a=a, b=b, g=g:
                                  torch._int_mm(xin[a:b], wt[g]))
                        for g, a, b in spans) for wt in (w_row, w_col))
        return min(row, col), (f"sum of per-expert torch._int_mm "
                               f"(column-major weight {col:.3f} ms, "
                               f"row-major {row:.3f} ms; the faster)")
    xin, w = xin.to(torch.bfloat16), w.to(torch.bfloat16)
    return sum(cuda_time(lambda a=a, b=b, g=g: torch.matmul(xin[a:b], w[g]))
               for g, a, b in spans), \
        "sum of per-expert torch.matmul (bf16 weight)"


# (mode, routed rows S, K, N, transposed weights)
K3_CASES = [
    ("W8A8", 8 * 623, 4096, 11264, False),
    ("W8A8", 8 * 623, 11264, 4096, False),
    ("int8-w", 4 * 1789, 4096, 11264, False),
    ("int8-w", 4 * 1789, 11264, 4096, False),
    ("float bf16", 4 * 1789, 4096, 11264, False),
    ("float bf16", 4 * 1087, 4096, 11008, False),
    ("float bf16", 4 * 1087, 11008, 4096, False),
    ("W8A8", 700, 1024, 768, True),
    ("int8-w", 700, 1024, 768, True),
]


def k3_phase(gen, dev, results):
    """gmm (K3) against gmm_plain, TF32 off, at the shapes its main paths
    give it: W8A8 at the int8-expert flagship prefill (S = 8 x 623 rows
    top-1 routed over 2 experts, two-ended aligned to Sp = 5632, bm 512;
    gate/up K 4096 -> N 11264 and down K 11264 -> N 4096); int8-w (bf16 x)
    at the ICL prefill (S = 4 x 1789, Sp = 7680), both shapes; float bf16
    at the ICL gate/up shape and at stage-4 validation's bf16 experts (S =
    4 x 1087, Sp = 5120, M = 11008 unpadded), both shapes; transposed
    weights (W8A8 and int8-w) at a
    small shape. Tolerances: W8A8 (s8 tensor cores) sums are exact
    integers on both sides and the epilogue the same rounded f32 ops in
    the same order -> bit-equal (the equal share is printed); the bf16-x
    modes (bf16 tensor cores) sum the
    same exact products in f32 in another order -> sum_order_close per
    expert (the largest error / bound is printed). The rate is the routed
    rows' products over the kernel time."""
    import torch
    from medplib_tpu_torch.ops.cuda import gmm as G
    bm = 512
    for mode, s, k, n, trans in K3_CASES:
        idx = torch.randint(0, 2, (s,), generator=gen, device=dev)
        xs = torch.randn((s, k), generator=gen, device=dev).to(torch.bfloat16)
        x_al, _, tile_gid = G.align_groups(xs, idx, 2, bm)
        assert int(tile_gid.min()) == 0 and int(tile_gid.max()) == 1
        wshape = (2, n, k) if trans else (2, k, n)
        w_s = a_s = None
        if mode == "float bf16":
            w = (torch.randn(wshape, generator=gen, device=dev)
                 * k ** -0.5).to(torch.bfloat16)
        else:
            w = torch.randint(-128, 128, wshape, generator=gen, device=dev,
                              dtype=torch.int8)
            w_s = torch.rand((2, 1, n), generator=gen, device=dev) * 0.01 \
                + 1e-3
        xin = x_al
        if mode == "W8A8":
            xin, a_s = G.quantize_rows(x_al)
        call = lambda: G.gmm(xin, w, tile_gid, w_s, a_s, bm,  # noqa: E731
                             transposed=trans)
        got = call()
        want = G.gmm_plain(xin, w, tile_gid, w_s, a_s, bm, transposed=trans)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rel = rel_err(got, want)
        if mode == "W8A8":
            ok = torch.equal(got, want)
            tol = (f"bit-equal: {ok}, "
                   f"{float((got == want).float().mean()) * 100:.4f}% equal")
        else:
            ok, eq, ratio = grouped_sum_order_close(got, want, xin, w, w_s,
                                                    tile_gid, bm, trans)
            tol = (f"within the f32 sum-order bound: {ok}, {eq * 100:.4f}% "
                   f"equal, largest error / bound {ratio:.4f}")
        ms = cuda_time(call)
        pms = cuda_time(lambda: G.gmm_plain(xin, w, tile_gid, w_s, a_s, bm,
                                            transposed=trans),
                        warmup=1, iters=2)
        # the routed rows' products; bytes of every operand
        ops = 2 * s * k * n
        bms, by = bound(nbytes(xin, w, tile_gid, got) + (
            nbytes(w_s) if w_s is not None else 0) + (
            nbytes(a_s) if a_s is not None else 0), ops,
            INT8_OPS if mode == "W8A8" else BF16_FLOPS)
        lib_ms, lib = _grouped_library_ms(xin, w.transpose(1, 2) if trans
                                          else w, tile_gid, bm)
        log(f"[K3 gmm {mode}{' transposed' if trans else ''}] "
            f"Sp={x_al.shape[0]} K={k} N={n}: max_abs_err={err:.3e} "
            f"rel={rel:.3e} ({tol}) kernel {ms:.3f} ms "
            f"({ops / ms / 1e9:.1f} T{'OP' if mode == 'W8A8' else 'FLOP'}"
            f"/s), plain {pms:.3f} ms, bound "
            f"{bms:.4f} ms ({by}), {lib} {lib_ms:.3f} ms "
            f"({ms / lib_ms:.2f}x)")
        if not ok:
            raise AssertionError(f"K3 {mode} K={k} N={n} disagrees with "
                                 f"plain")
        if mode == "W8A8" and not trans and k == 4096:
            results["gmm"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                  bound_ms=bms, bound_by=by,
                                  library_ms=lib_ms)
        del xs, x_al, xin, w, got, want
    torch.cuda.empty_cache()


def grouped_sum_order_close(got, want, x, w, w_s, tile_gid, bm, trans):
    """sum_order_close over the rows of each expert of a grouped matmul,
    against that expert's weight (times its scale) -> (ok, share of equal
    elements, largest error / bound)."""
    import torch
    rows = tile_gid.long().repeat_interleave(bm)
    oks, ratios = [], []
    for g in range(w.shape[0]):
        sel = rows == g
        wg = (w[g].t() if trans else w[g]).float()
        if w_s is not None:
            wg = wg * w_s[g]
        ok, _, ratio = sum_order_close(got[sel], want[sel],
                                       x[sel].to(torch.bfloat16), wg)
        oks.append(ok)
        ratios.append(ratio)
    return all(oks), float((got == want).float().mean()), max(ratios)


def sum_order_close(got, want, x, w_deq):
    """|got - want| <= both f32 summation error bounds (K * 2^-24 *
    sum_k |x w| each) + one rounding of the output dtype: the tolerance of
    a kernel whose f32 sums take another order than its plain version's
    (the bound is computed in f32, TF32 off). -> (ok, share of equal
    elements, largest |got - want| / bound)."""
    import torch
    k = x.shape[-1]
    sums = x.float().abs() @ w_deq.float().abs()
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -23
    d = (got.float() - want.float()).abs()
    tol = 2 * k * 2.0 ** -24 * sums + want.float().abs() * ulp
    return bool((d <= tol).all()), float((got == want).float().mean()), \
        float((d / tol.clamp(min=1e-30)).max())   # zero rows: 0 / 0


# K7 / K9 at the packed dense serving shapes: (case, M, K, N, transposed);
# M is B x 623 spliced tokens at prefill (int8 B=16, int4h B=12), B at
# decode; qkv_proj [3H, H] is stored transposed, gateup_proj [H, 2I] not
K7_CASES = [
    ("prefill qkv", 16 * 623, 4096, 3 * 4096, True),
    ("prefill gate-up", 16 * 623, 4096, 2 * 11008, False),
    ("decode qkv", 16, 4096, 3 * 4096, True),
    ("decode gate-up", 16, 4096, 2 * 11008, False),
]
K9_CASES = [(c, m // 16 * 12, k, n, t) for c, m, k, n, t in K7_CASES]


def _time_three(kern, plain, library, iters):
    return (cuda_time(kern, iters=iters), cuda_time(plain, 1, 2),
            cuda_time(library, iters=iters))


def k7_phase(gen, dev, results):
    """int8_matmul (K7) against its plain version, TF32 off, bf16 x, at the
    packed int8 serving shapes (K7_CASES). Tolerance: the same exact
    products summed in f32 in another order (sum_order_close). Yardsticks,
    never used by the port: torch.matmul against the weight dequantized to
    bf16 beforehand (library_ms), and torch._weight_int8pack_mm where this
    build has it on CUDA."""
    import torch
    from medplib_tpu_torch.ops.cuda import int8_matmul as I8
    bf = torch.bfloat16
    for case, m, k, n, trans in K7_CASES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf)
        w = torch.randint(-128, 128, (n, k) if trans else (k, n),
                          generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand((n, 1) if trans else (1, n), generator=gen,
                       device=dev) * 0.01 + 1e-3
        got = I8.int8_matmul_2d(x, w, s, trans)
        want = I8.int8_matmul_plain(x, w, s, trans)
        torch.cuda.synchronize()
        w_deq = (w.float() * s).to(bf)              # the library's operand
        w_kn = w_deq.t() if trans else w_deq
        ok, eq, ratio = sum_order_close(got, want, x, w_kn)
        err = float((got.float() - want.float()).abs().max())
        iters = 20 if m <= 16 else 5
        ms, pms, lib_ms = _time_three(
            lambda: I8.int8_matmul_2d(x, w, s, trans),
            lambda: I8.int8_matmul_plain(x, w, s, trans),
            lambda: x @ w_kn, iters)
        bms, by = bound(nbytes(x, w, s, got), 2 * m * k * n, BF16_FLOPS)
        w_nk = w if trans else w.t().contiguous()
        try:       # a yardstick only: report whether this build has it
            i8mm = cuda_time(lambda: torch._weight_int8pack_mm(
                x, w_nk, s.reshape(-1).to(bf)), iters=iters)
            i8mm = f"{i8mm:.3f} ms"
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            i8mm = f"absent ({type(e).__name__}: {str(e)[:80]})"
        log(f"[K7 int8_matmul {case}{' transposed' if trans else ''}] M={m} "
            f"K={k} N={n}: max_abs_err={err:.3e}, {eq * 100:.4f}% equal "
            f"(within the f32 sum-order bound: {ok}; largest error / bound "
            f"{ratio:.4f}) kernel {ms:.3f} ms "
            f"({2 * m * k * n / ms / 1e9:.1f} TFLOP/s), plain {pms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}), torch.matmul (bf16 weight) "
            f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x), "
            f"torch._weight_int8pack_mm {i8mm}")
        if not ok:
            raise AssertionError(f"K7 {case} disagrees with plain")
        if case == "prefill gate-up":
            results["int8_matmul"] = dict(max_abs_err=err, ms=ms,
                                          plain_ms=pms, bound_ms=bms,
                                          bound_by=by, library_ms=lib_ms)
        del x, w, s, got, want, w_deq, w_kn, w_nk
    torch.cuda.empty_cache()


# K8 at the dense W8A8 shapes, both layouts: (M, K, N, transposed)
K8_CASES = [(16 * 623, 4096, 3 * 4096, True),
            (16 * 623, 4096, 3 * 4096, False),
            (16 * 623, 11008, 4096, False),
            (16 * 623, 11008, 4096, True)]


def k8_phase(gen, dev, results):
    """w8a8_matmul (K8, on no path; s8 mma.sync) against its plain version
    at the dense W8A8 shapes (K8_CASES), x quantized per row beforehand
    (outside the kernel, as in the reference). Exact s32 sums and the same
    rounded epilogue on both sides: bit-equal, in bf16 and in f32 output.
    Yardsticks: torch._int_mm on the same int8 operands, the weight
    row-major [K, N] and column-major (library_ms: the column-major
    one)."""
    import torch
    from medplib_tpu_torch.ops.cuda import int8_matmul as I8
    for m, k, n, trans in K8_CASES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        x_q, a_s = I8.quantize_rows(x)
        w = torch.randint(-127, 128, (n, k) if trans else (k, n),
                          generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand((n, 1) if trans else (1, n), generator=gen,
                       device=dev) * 0.01 + 1e-3
        call = lambda: I8.w8a8_matmul_2d(  # noqa: E731
            x_q, a_s, w, s, trans, torch.bfloat16)
        got = call()
        want = I8.w8a8_matmul_plain(x_q, a_s, w, s, trans, torch.bfloat16)
        got32 = I8.w8a8_matmul_2d(x_q, a_s, w, s, trans, torch.float32)
        want32 = I8.w8a8_matmul_plain(x_q, a_s, w, s, trans, torch.float32)
        torch.cuda.synchronize()
        equal = torch.equal(got, want) and torch.equal(got32, want32)
        err = float((got.float() - want.float()).abs().max())
        del got32, want32
        w_row = w.t().contiguous() if trans else w       # [K, N] row-major
        w_col = w.t() if trans else w.t().contiguous().t()
        ms, pms, lib_ms = _time_three(
            call, lambda: I8.w8a8_matmul_plain(x_q, a_s, w, s, trans,
                                               torch.bfloat16),
            lambda: torch._int_mm(x_q, w_col), 5)
        row_ms = cuda_time(lambda: torch._int_mm(x_q, w_row), iters=5)
        ops = 2 * m * k * n
        bms, by = bound(nbytes(x_q, a_s, w, s, got), ops, INT8_OPS)
        log(f"[K8 w8a8_matmul{' transposed' if trans else ''}] M={m} K={k} "
            f"N={n}: max_abs_err={err:.3e} (bit-equal in bf16 and f32: "
            f"{equal}) kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} TOP/s), "
            f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by}), torch._int_mm "
            f"column-major weight {lib_ms:.3f} ms ({ms / lib_ms:.2f}x), "
            f"row-major {row_ms:.3f} ms ({ms / row_ms:.2f}x)")
        if not equal:
            raise AssertionError(f"K8 K={k} N={n} disagrees with plain")
        if "w8a8_matmul" not in results:
            results["w8a8_matmul"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, launches=0)
        del x, x_q, a_s, w, s, got, want, w_row, w_col
    torch.cuda.empty_cache()


def k9_phase(gen, dev, results):
    """int4h_matmul (K9, bf16 x: the tensor-core kernel) against its plain
    version, TF32 off, at the packed int4h serving shapes (K9_CASES:
    B=12), G = 8 scale groups. Tolerance: the plain version's f32 sums in
    another order plus one rounding per weight (sum_order_close; the
    largest |got - want| / bound is printed). Yardstick: torch.matmul
    against the weight dequantized to bf16 beforehand."""
    import torch
    from medplib_tpu_torch.ops.cuda import int4_matmul as I4
    bf, g = torch.bfloat16, 8
    for case, m, k, n, trans in K9_CASES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf)
        packed = torch.randint(-128, 128, (n, k // 2) if trans
                               else (k // 2, n), generator=gen, device=dev,
                               dtype=torch.int8)
        s = torch.rand((g, n, 1) if trans else (g, 1, n), generator=gen,
                       device=dev) * 0.01 + 1e-3
        got = I4.int4h_matmul_2d(x, packed, s, trans)
        want = I4.int4h_matmul_plain(x, packed, s, trans)
        torch.cuda.synchronize()
        w_kn = I4.dequant_f32(packed, s, trans).to(bf)    # [K, N]
        ok, eq, ratio = sum_order_close(got, want, x, w_kn)
        err = float((got.float() - want.float()).abs().max())
        ms, pms, lib_ms = _time_three(
            lambda: I4.int4h_matmul_2d(x, packed, s, trans),
            lambda: I4.int4h_matmul_plain(x, packed, s, trans),
            lambda: x @ w_kn, 20 if m <= 16 else 5)
        bms, by = bound(nbytes(x, packed, s, got), 2 * m * k * n,
                        BF16_FLOPS)
        log(f"[K9 int4h_matmul {case}{' transposed' if trans else ''}] "
            f"M={m} K={k} N={n} G={g}: max_abs_err={err:.3e}, "
            f"{eq * 100:.4f}% equal (within the f32 sum-order bound: {ok}; "
            f"largest error / bound {ratio:.4f}) kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {bms:.4f} ms ({by}), torch.matmul (bf16 "
            f"weight) {lib_ms:.3f} ms ({ms / lib_ms:.2f}x)")
        if not ok:
            raise AssertionError(f"K9 {case} disagrees with plain")
        if case == "prefill gate-up":
            results["int4h_matmul"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=pms, bound_ms=bms,
                                           bound_by=by, library_ms=lib_ms)
        del x, packed, s, got, want, w_kn
    torch.cuda.empty_cache()


def ragged_phase(gen, dev):
    """One call per wrapper at widths no multiple of what the kernels' loads
    take, against the plain versions: K7 / K8 / K3 at N = 320, K = 688
    (padded by the wrappers), K9 bf16 and f32 x at the same widths (the
    tensor-core kernel takes them as they are), K1 at N = 208, K = 768 (its
    64-column tile; K / 2 % 128 == 0 as in the JAX kernel); then a
    1024-token prompt with head_dim 256, which must take the plain
    attention (the flash kernels take head_dim 128)."""
    import torch
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import int4_matmul as I4
    from medplib_tpu_torch.ops.cuda import int8_matmul as I8
    bf = torch.bfloat16
    m, k, n = 300, 688, 320
    x = torch.randn((m, k), generator=gen, device=dev).to(bf)
    fails = []

    def report(name, ok, detail):
        log(f"[ragged {name}] {detail} (ok: {ok})")
        if not ok:
            fails.append(name)

    for trans in (False, True):
        w = torch.randint(-128, 128, (n, k) if trans else (k, n),
                          generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand((n, 1) if trans else (1, n), generator=gen,
                        device=dev) * 0.01 + 1e-3
        got = I8.int8_matmul_2d(x, w, sc, trans)
        want = I8.int8_matmul_plain(x, w, sc, trans)
        wd = w.float() * sc
        ok, eq, _ = sum_order_close(got, want, x, wd.t() if trans else wd)
        report(f"K7 trans={trans}", ok and got.shape == (m, n),
               f"M={m} K={k} N={n}: {eq * 100:.2f}% equal")
        xq, a_s = I8.quantize_rows(x)
        for od in (bf, torch.float32):
            got = I8.w8a8_matmul_2d(xq, a_s, w, sc, trans, od)
            want = I8.w8a8_matmul_plain(xq, a_s, w, sc, trans, od)
            report(f"K8 {od} trans={trans}", torch.equal(got, want),
                   "bit-equal to plain")
        packed = torch.randint(-128, 128, (n, k // 2) if trans
                               else (k // 2, n), generator=gen, device=dev,
                               dtype=torch.int8)
        s4 = torch.rand((8, n, 1) if trans else (8, 1, n), generator=gen,
                        device=dev) * 0.01 + 1e-3
        for xd in (bf, torch.float32):
            got = I4.int4h_matmul_2d(x.to(xd), packed, s4, trans)
            want = I4.int4h_matmul_plain(x.to(xd), packed, s4, trans)
            ok, eq, ratio = sum_order_close(got, want, x.to(xd),
                                            I4.dequant_f32(packed, s4, trans))
            report(f"K9 {xd} trans={trans}", ok and got.shape == (m, n),
                   f"G=8: {eq * 100:.2f}% equal, error / bound {ratio:.4f}")
    e, bm = 2, 64
    idx = torch.randint(0, e, (m,), generator=gen, device=dev)
    x_al, _, gid = G.align_groups(x, idx, e, bm)
    w = torch.randint(-128, 128, (e, k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    ws = torch.rand((e, 1, n), generator=gen, device=dev) * 0.01 + 1e-3
    xq, a_s = G.quantize_rows(x_al)
    for mode, xin, aa in (("W8A8", xq, a_s), ("int8-w", x_al, None)):
        got = G.gmm(xin, w, gid, ws, aa, bm)
        want = G.gmm_plain(xin, w, gid, ws, aa, bm)
        if aa is not None:
            ok, detail = torch.equal(got, want), "bit-equal to plain"
        else:
            ok, eq, ratio = grouped_sum_order_close(got, want, xin, w, ws,
                                                    gid, bm, False)
            detail = f"{eq * 100:.2f}% equal, error / bound {ratio:.4f}"
        report(f"K3 {mode}", ok and got.shape[1] == n,
               f"K={k} N={n}: {detail}")
    k1, n1 = 768, 208
    packed, s1 = _random_int4h(gen, e, k1, n1, dev)
    xs = torch.randn((m, k1), generator=gen, device=dev)
    x_al, _, gid = G.align_groups(xs, idx, e, bm)
    xq, a_s = G.quantize_rows(x_al)
    got = G.gmm_int4h(xq, packed, s1, gid, a_s, bm)
    want = G.gmm_int4h_plain(xq, packed, s1, gid, a_s, bm)
    report("K1 A8", torch.equal(got, want) and got.shape[1] == n1,
           f"K={k1} N={n1}: bit-equal to plain")
    q, kk, v = (torch.randn((1, 1024, 2, 256), generator=gen, device=dev)
                for _ in range(3))
    n0 = FA.flash_forward.launches
    got = A.causal_attention(q, kk, v)
    want = A._plain_attention(q, kk, v,
                              A.make_causal_bias(None, 1024, 1024,
                                                 device=dev))
    torch.cuda.synchronize()
    report("attention head_dim 256", FA.flash_forward.launches == n0 and
           rel_err(got, want) <= 1e-6, "T=1024: plain path, no flash launch")
    if fails:
        raise AssertionError(f"ragged shapes disagree: {fails}")


# peak rates of one H100 SXM (dense, NVIDIA's data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def bound(n_bytes: float, ops: float, rate: float):
    """-> (least ms the card could take, "bytes" or "operations")."""
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _flash_inputs(gen, dev, b, t, s, h, d, lens=None, dv=None):
    """lens: the B rows' kept lengths of a right-padded mask, as a serving
    batch has; else padded tails of 10 i keys and, at T = S, a row whose
    first queries keep no key. dv: v's head size (default d)."""
    import torch
    bf = torch.bfloat16
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf)
    k = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf)
    v = torch.randn((b, s, h, dv or d), generator=gen, device=dev).to(bf)
    if lens is not None:
        mask = (torch.arange(s, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
    else:
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        for i in range(b):      # padded tails of 0..70 keys
            mask[i, s - 10 * i:] = 0
        if t == s:
            mask[1, :5] = 0     # row 1's first 5 queries keep no key
    dout = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf)
    return q, k, v, mask, dout


# mma FLOP a kept (query, key) pair, in units of D: what the table counts
# (S, then P V / dP and dS K / dP, P^T dO and dS^T Q) and what the bf16
# tensor-core kernels run (the P / dS products twice: hi + lo)
FLASH_FLOP_D = {"flash_fwd": (4, 6), "flash_bwd_dq": (6, 8),
                "flash_bwd_dkv": (8, 12)}


def _serve_lens(b: int, t: int):
    """Kept lengths of a right-padded serving batch of B rows padded to T:
    evenly spread over the last 64 tokens (the grounded-VQA batch's rows
    are 623-687 spliced tokens long)."""
    return tuple(t - round(64 * (b - 1 - i) / max(b - 1, 1))
                 for i in range(b))


# the serving prefill's K4 shapes (every head_dim-128 prompt takes K4):
# the main path's B=16 and B=1 calls at 623 spliced tokens, and the
# grounded-VQA benchmark's B=16 x 687 with rows of 623-687 tokens
FLASH_SERVE_SHAPES = ((16, 623), (16, 687), (1, 623))
# K4 <192, 128> at DeepSeek-V2-Lite's serving prefill (16 heads of q / k
# 192 and v 128, YaRN's softmax scale): the dsv2lite-ground-b64
# benchmark's B=64 x 687 with rows of 623-687 tokens, and one 623-token row
MLA_SERVE_SHAPES = ((64, 687), (1, 623))


def mla_serve_scale() -> float:
    """DeepSeek-V2-Lite's softmax scale: 192^-0.5 times YaRN's mscale^2."""
    from medplib_tpu_torch.config import MlaConfig, YarnScaling
    from medplib_tpu_torch.ops.rope import mla_softmax_scale
    return mla_softmax_scale(MlaConfig(rope_scaling=YarnScaling()))


def flash_phase(gen, dev, results):
    """K4 / K5 / K6 at the training shape: B=8, T=S=1087 (the spliced
    stage-3 row), H=32, D=128, bf16, with padded key tails and, at T=S, a
    row whose first queries keep no key; then once with T < S, and at the
    ICL shape (B=4, T=S=1789, the 3-image spliced row). Each kernel
    against its plain version on the same inputs (the backward ones from
    the kernel's lse and delta), timed at the training shape with CUDA
    events beside the plain version and torch's
    scaled_dot_product_attention (boolean causal+keep mask) forward and
    backward; K4 also at the ICL shape, where it runs on a serving path.
    Then K4 alone at the serving prefill's shapes (FLASH_SERVE_SHAPES,
    right-padded rows), against its plain version, and at B=16 timed
    beside the route's plain attention (make_causal_bias +
    _plain_attention, which these prompts took below 1024 tokens before
    the route lost its length test); those times go into the kernels
    line under flash_fwd's "serve". The same for the <192, 128>
    instantiation at MLA_SERVE_SHAPES with the YaRN scale, each counted
    as one launch of it.

    Tolerances: out, dq, dk, dv are bf16 results of f32 sums taken in
    another order, so at most a rare one-ulp rounding flip: relative
    Frobenius error <= 1e-3. lse is f32: max abs error <= 1e-4. Rows that
    keep no key are checked for finiteness only (their forward output
    depends on the tile schedule)."""
    import torch
    import torch.nn.functional as F
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    h, d = 32, 128
    for b, t, s in ((8, 1087, 1087), (8, 1000, 1087), (4, 1789, 1789)):
        q, k, v, mask, dout = _flash_inputs(gen, dev, b, t, s, h, d)
        keep = FA._keep(mask, t, s)                       # [B, 1, T, S]
        live = keep.any(-1)[:, 0]                         # [B, T]
        pairs = float(keep.sum()) * h                     # kept (q, k) pairs
        out, lse = FA.flash_forward(q, k, v, mask)
        want_out, want_lse = FA.flash_forward_plain(q, k, v, mask)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = FA.flash_dq(q, k, v, mask, dout, lse, delta)
        dk, dv = FA.flash_dkv(q, k, v, mask, dout, lse, delta)
        want_dq = FA.flash_dq_plain(q, k, v, mask, dout, lse, delta)
        want_dk, want_dv = FA.flash_dkv_plain(q, k, v, mask, dout, lse, delta)
        torch.cuda.synchronize()
        lv = live[..., None].expand(-1, -1, h)            # [B, T, H]
        errs = {
            "out": (rel_err(out[lv], want_out[lv]),
                    float((out[lv].float() - want_out[lv].float()).abs()
                          .max())),
            "lse": (None, float((lse.transpose(1, 2)[lv]
                                 - want_lse.transpose(1, 2)[lv]).abs()
                                .max())),
            "dq": (rel_err(dq, want_dq),
                   float((dq.float() - want_dq.float()).abs().max())),
            "dk": (rel_err(dk, want_dk),
                   float((dk.float() - want_dk.float()).abs().max())),
            "dv": (rel_err(dv, want_dv),
                   float((dv.float() - want_dv.float()).abs().max())),
        }
        finite = all(bool(torch.isfinite(x.float()).all())
                     for x in (out, lse, dq, dk, dv))
        ok = finite and errs["lse"][1] <= 1e-4 and all(
            r <= 1e-3 for n, (r, _) in errs.items() if n != "lse")
        log(f"[flash B={b} T={t} S={s}] " + ", ".join(
            f"{n} max_abs_err={a:.3e}" + ("" if r is None else f" rel={r:.3e}")
            for n, (r, a) in errs.items())
            + f"; {int((~live).sum())} rows keep no key (finite: {finite})"
            " (rel Frobenius <= 1e-3, lse max abs <= 1e-4)")
        if not ok:
            raise AssertionError(f"flash kernels disagree with plain at "
                                 f"B={b} T={t} S={s}")
        if t != s:
            continue
        # timings at T = S: all three at the training shape, K4 at ICL's
        sq, sk, sv = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            sq, sk, sv, attn_mask=keep)
        if b == 4:
            ms = cuda_time(lambda: FA.flash_forward(q, k, v, mask))
            pms = cuda_time(lambda: FA.flash_forward_plain(q, k, v, mask),
                            warmup=1, iters=2)
            lib_ms = cuda_time(sdpa)
            counted, run = FLASH_FLOP_D["flash_fwd"]
            ops = counted * d * pairs
            bms, by = bound(nbytes(q, k, v, mask, out, lse), ops, BF16_FLOPS)
            log(f"[flash_fwd] ICL B={b} T=S={t} H={h} D={d}: kernel "
                f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s at {counted}·D "
                f"FLOP a kept pair, {ops * run / counted / ms / 1e9:.1f} at "
                f"the {run}·D it runs), plain {pms:.3f} ms, SDPA fwd "
                f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x), bound {bms:.4f} ms "
                f"({by})")
            del sq, sk, sv
            torch.cuda.empty_cache()
            continue
        qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        gout = dout.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
            torch.autograd.grad(o, (qg, kg, vg), gout)

        fwd_lib = cuda_time(sdpa)
        bwd_lib = cuda_time(sdpa_fwd_bwd) - fwd_lib
        rows = nbytes(lse, delta)
        specs = {
            "flash_fwd": (
                lambda: FA.flash_forward(q, k, v, mask),
                lambda: FA.flash_forward_plain(q, k, v, mask),
                nbytes(q, k, v, mask, out, lse), 4 * d * pairs, fwd_lib,
                max(errs["out"][1], errs["lse"][1])),
            "flash_bwd_dq": (
                lambda: FA.flash_dq(q, k, v, mask, dout, lse, delta),
                lambda: FA.flash_dq_plain(q, k, v, mask, dout, lse, delta),
                nbytes(q, k, v, mask, dout, dq) + rows, 6 * d * pairs,
                bwd_lib, errs["dq"][1]),
            "flash_bwd_dkv": (
                lambda: FA.flash_dkv(q, k, v, mask, dout, lse, delta),
                lambda: FA.flash_dkv_plain(q, k, v, mask, dout, lse, delta),
                nbytes(q, k, v, mask, dout, dk, dv) + rows, 8 * d * pairs,
                bwd_lib, max(errs["dk"][1], errs["dv"][1])),
        }
        for name, (kern, plain, nb, ops, lib_ms, err) in specs.items():
            lib = "fwd" if name == "flash_fwd" else "bwd (dq, dk, dv)"
            ms = cuda_time(kern)
            pms = cuda_time(plain, warmup=1, iters=2)
            bms, by = bound(nb, ops, BF16_FLOPS)
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound_ms=bms, bound_by=by,
                                 library_ms=lib_ms)
            counted, run = FLASH_FLOP_D[name]
            log(f"[{name}] B={b} T=S={t} H={h} D={d}: kernel {ms:.3f} ms "
                f"({ops / ms / 1e9:.1f} TFLOP/s at {counted}·D FLOP a kept "
                f"pair, {ops * run / counted / ms / 1e9:.1f} at the {run}·D "
                f"it runs), plain {pms:.3f} ms, SDPA {lib} "
                f"{lib_ms:.3f} ms ({ms / lib_ms:.2f}x), bound {bms:.4f} ms "
                f"({by}: {nb / 1e6:.1f} MB, {ops / 1e9:.1f} GFLOP)")
        del sq, sk, sv, qg, kg, vg
        torch.cuda.empty_cache()
    results["flash_fwd"]["serve"] = [
        flash_serve_case(gen, dev, b, t, h, d)
        for b, t in FLASH_SERVE_SHAPES] + [
        flash_serve_case(gen, dev, b, t, 16, 192, dv=128,
                         scale=mla_serve_scale())
        for b, t in MLA_SERVE_SHAPES]


def flash_serve_case(gen, dev, b, t, h, d, dv=None, scale=None):
    """K4 at one serving prefill shape (v heads of dv, default d; softmax
    scale default d^-0.5) against flash_forward_plain (rel Frobenius
    <= 1e-3, lse max abs <= 1e-4); at B > 1 also timed with CUDA events
    beside the route's plain attention. -> the kernels line's record of
    the shape."""
    import torch
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    dv = dv or d
    lens = _serve_lens(b, t)
    q, k, v, mask, _ = _flash_inputs(gen, dev, b, t, t, h, d, lens, dv)
    n0 = FA.flash_forward.launches_qk192
    out, lse = FA.flash_forward(q, k, v, mask, scale)
    want_out, want_lse = FA.flash_forward_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    if FA.flash_forward.launches_qk192 - n0 != int(dv != d):
        raise AssertionError(f"K4 <{d}, {dv}>: the <192, 128> launch count "
                             f"moved by {FA.flash_forward.launches_qk192 - n0}")
    rel = rel_err(out, want_out)
    err = float((out.float() - want_out.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    finite = bool(torch.isfinite(out.float()).all())
    log(f"[flash serve B={b} T=S={t} H={h} D={d} Dv={dv}"
        + ("" if scale is None else f" scale={scale:.6f}")
        + f"] rows keep {lens[0]}..{lens[-1]}"
        f" keys: out max_abs_err={err:.3e} rel={rel:.3e}, lse max_abs_err="
        f"{lse_err:.3e} (rel Frobenius <= 1e-3, lse max abs <= 1e-4)")
    if not (finite and rel <= 1e-3 and lse_err <= 1e-4):
        raise AssertionError(f"flash forward disagrees with plain at the "
                             f"serving shape B={b} T=S={t}")
    rec = dict(B=b, T=t, H=h, D=d, Dv=dv, lens=[lens[0], lens[-1]],
               max_abs_err=err)
    if b == 1:
        return rec
    bias = lambda: A.make_causal_bias(mask, t, t, device=dev)  # noqa: E731
    ms = cuda_time(lambda: FA.flash_forward(q, k, v, mask, scale))
    pms = cuda_time(lambda: A._plain_attention(q, k, v, bias(), scale),
                    warmup=1, iters=3)
    pairs = float(FA._keep(mask, t, t).sum()) * h
    # q . k over d, then P V over dv (run twice: P split hi + lo)
    counted, run = 2 * d + 2 * dv, 2 * d + 4 * dv
    ops = counted * pairs
    bms, by = bound(nbytes(q, k, v, mask, out, lse), ops, BF16_FLOPS)
    log(f"[flash_fwd] serve B={b} T=S={t} H={h} D={d} Dv={dv}: kernel "
        f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s at {counted} FLOP a "
        f"kept pair, {ops * run / counted / ms / 1e9:.1f} at the {run} it "
        f"runs; "
        f"{100 * bms / ms:.1f}% of the bound), the route's plain attention "
        f"{pms:.3f} ms ({pms / ms:.1f}x), bound {bms:.4f} ms ({by})")
    del q, k, v, out, want_out
    torch.cuda.empty_cache()
    return dict(rec, ms=ms, route_plain_ms=pms, bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------------------
# model set-up
# ---------------------------------------------------------------------------

def make_batch(cfg, b, t, rng, dev):
    """The bench batch (__graft_entry__._make_batch): random ids with BOS,
    an <image> sentinel at 2 and <SEG> at T-3; CLIP pixels N(0,1); SAM
    pixels raw 0..255 floats; one random binary ground-truth mask per row
    at the SAM frame, valid."""
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
    gt = (rng.uniform(size=(b, 1, ss, ss)) > 0.5).astype(np.float32)
    td = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return Batch.make(
        input_ids=td(ids), input_mask=td(np.ones((b, t), np.int32)),
        labels=td(labels), images_clip=td(clip_px), images_sam=td(sam_px),
        image_token_lengths=td(np.full((b, 1), cfg.vision.num_patches,
                                       np.int32)),
        gt_masks=td(gt), mask_valid=td(np.ones((b, 1), bool)),
        sam_frame=ss)


def init_flagship(cfg, gen, dev, expert_bits=4):
    """Random MedPLIB-7b-2e in its serving quantization, built the way
    _init_flagship_moe_quantized builds it: a bf16 dense skeleton without
    the dense MLP, int8-quantized; then the experts initialized, padded
    (M 11008 -> 11264) and quantized ONE LAYER AT A TIME (int4h with
    per-half scales for expert_bits=4, int8 per channel for 8), so the
    bf16 expert stacks never exist whole."""
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
    skey = "scale4h" if expert_bits == 4 else "scale"
    nodes = {n: {"kernel": [], skey: []}
             for n in ("gate_proj", "up_proj", "down_proj")}
    for _ in range(L):
        one = moe_llama.init_experts(gen, cfg.llm, cfg.moe, bf, dev)
        one = qz.pad_moe_experts_for_gmm(one)
        one = qz.quantize_tree(one, skip=(), bits=expert_bits,
                               int4_groups=2)
        for n in nodes:
            for k in ("kernel", skey):
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

def _wrappers():
    """name -> the kernel wrapper that counts its launches."""
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import int4_matmul as I4
    from medplib_tpu_torch.ops.cuda import int8_matmul as I8
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    from medplib_tpu_torch.ops.cuda import moe_prefill as P
    return {"gmm_int4h": G.gmm_int4h,
            "moe_ffn_decode_int4h": D.moe_ffn_decode_int4h, "gmm": G.gmm,
            "flash_fwd": FA.flash_forward, "flash_bwd_dq": FA.flash_dq,
            "flash_bwd_dkv": FA.flash_dkv,
            "int8_matmul": I8.int8_matmul_2d,
            "w8a8_matmul": I8.w8a8_matmul_2d,
            "int4h_matmul": I4.int4h_matmul_2d,
            "moe_dispatch_quant": P.moe_dispatch_quant,
            "moe_swiglu_quant": P.moe_swiglu_quant,
            "moe_topk_combine": P.moe_topk_combine}


def reset_counts() -> None:
    for f in _wrappers().values():
        f.launches = 0


def kernel_counts() -> dict:
    return {n: f.launches for n, f in _wrappers().items()}


def flash_counts():
    c = kernel_counts()
    return (c["flash_fwd"], c["flash_bwd_dq"], c["flash_bwd_dkv"])


# the MoE prefill's int8 passes around K1 / K3 (ops/cuda/moe_prefill.py)
PREFILL_PASSES = ("moe_dispatch_quant", "moe_swiglu_quant",
                  "moe_topk_combine")


def expect_counts(where: str, got: dict, **want) -> None:
    """Fail unless every named kernel launched exactly `want` times (the
    kernels not named: none). Where a site names none of the prefill
    passes, they follow the grouped matmuls instead: dispatch and
    SwiGLU-quantize launch together, once per act-quantized grouped
    SwiGLU (three K1 or K3 launches), and the top-k combine not at all."""
    if any(n in want for n in PREFILL_PASSES):
        ok = got == {n: want.get(n, 0) for n in got}
    else:
        ok = {n: c for n, c in got.items() if n not in PREFILL_PASSES} == \
            {n: want.get(n, 0) for n in got if n not in PREFILL_PASSES}
        d, a, c = (got.get(n, 0) for n in PREFILL_PASSES)
        ok = ok and d == a and 3 * d <= got["gmm_int4h"] + got["gmm"] \
            and c == 0
    log(f"[{where}] launches {got} (want {want}, others 0)")
    if not ok:
        raise AssertionError(f"{where}: the path did not run the kernels as "
                             f"expected")


def tiny_serving_cfg(hidden: int, heads: int):
    """The tiny MoE serving model of the card-vs-CPU checks: 2 layers x 2
    experts, M = 1024, head_dim 64; tiny CLIP (16 patches) and SAM."""
    from medplib_tpu_torch import config as C
    llm = C.LlamaConfig(vocab_size=512, hidden_size=hidden,
                        intermediate_size=1024, num_layers=2,
                        num_heads=heads, num_kv_heads=heads, head_dim=64)
    return C.MedplibConfig(
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
        projector=C.ProjectorConfig(mm_hidden_size=64, hidden_size=hidden),
        moe=C.MoeConfig(enable=True, num_experts=2, top_k=1),
        seg=C.SegConfig(out_dim=32), seg_token_idx=500, vocab_size_padded=512)


def _tiny_moe_tree(cfg, expert_bits):
    """The tiny MoE serving params in their flagship quantization, as a
    numpy tree: f32 init, unit-scale embeddings (a well-conditioned
    residual stream, so that last-bit differences do not flip greedy
    tokens), quantize_flagship_moe."""
    import torch
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.convert import tree_to_numpy
    from medplib_tpu_torch.utils.quantize import quantize_flagship_moe
    p = medplib.init_medplib(torch.Generator().manual_seed(1), cfg,
                             torch.float32, "cpu")
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    return tree_to_numpy(quantize_flagship_moe(p, expert_bits, 8))


def _tiny_card_vs_cpu(dev, name, cfg, host, kv_quant, actq=True, make=None,
                      gen_kw=None, tree_at=None, **want):
    """Generate (by default B=16 x T_in=64: 1264 spliced tokens; 4 new
    tokens; W8A8 prefill with actq) with the same tiny params `host` (a
    numpy tree) on the CPU (plain versions) and on the card (kernels);
    tokens and masks must agree and the card must launch exactly `want`.
    make(where) builds another batch; gen_kw adds generate arguments;
    tree_at(where) builds the params on each device in place of host."""
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.convert import tree_from_numpy
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant
    make = make or (lambda where: make_batch(
        cfg, 16, 64, np.random.default_rng(0), where))
    out = {}
    for where in ("cpu", dev):
        b = make(where)
        reset_counts()
        with dynamic_act_quant(actq):
            p = tree_at(where) if tree_at else tree_from_numpy(host, where)
            r = medplib.generate(p, cfg, b,
                                 max_new_tokens=4, kv_quant=kv_quant,
                                 **(gen_kw or {}))
        out[str(where)] = (r, kernel_counts())
    (rc, nc), (rg, ng) = out["cpu"], out[str(dev)]
    same = float((rc.output_ids == rg.output_ids.cpu()).float().mean())
    mrel = rel_err(rg.pred_masks.cpu(), rc.pred_masks)
    bsz, t_in = b.input_ids.shape
    log(f"[{name}] B={bsz} T_in={t_in} tiny slice, card vs CPU plain: "
        f"tokens equal {same * 100:.1f}%, mask rel err {mrel:.3e}")
    expect_counts(name + ", CPU", nc)
    expect_counts(name + ", card", ng, **want)
    # last-bit differences between the card's and the CPU's float sums can
    # flip a rare act-quant rounding; require near-total agreement
    if same < 0.9 or mrel > 5e-2:
        raise AssertionError(f"{name}: the tiny slice disagrees with the CPU")


def small_check(dev):
    """int4h experts (H=512): K1 at prefill, K2 at decode."""
    cfg = tiny_serving_cfg(512, 8)
    _tiny_card_vs_cpu(dev, "small check", cfg, _tiny_moe_tree(cfg, 4),
                      False, gmm_int4h=6, moe_ffn_decode_int4h=8,
                      moe_dispatch_quant=2, moe_swiglu_quant=2)


def small_int8_check(dev):
    """int8 experts at H = M = 1024 (multiples of 1024: the whole-stack
    int8 gmm engages), int8 KV cache: K3 at prefill, sort path at
    decode."""
    cfg = tiny_serving_cfg(1024, 16)
    _tiny_card_vs_cpu(dev, "small int8 check", cfg, _tiny_moe_tree(cfg, 8),
                      True, gmm=6, moe_dispatch_quant=2, moe_swiglu_quant=2)


def small_packed_check(dev, bits):
    """A tiny packed dense model (H=256, 2 layers, M=512): f32 init,
    unit-scale embeddings, pack_inference, quantize_tree(bits). int8 under
    W8A8: the packed qkv / gate-up kernels on K7 (2 per layer per LLM
    pass: 2 x 2 x (1 + 4)); int4h without act quant: on K9."""
    import dataclasses as dc

    import torch
    from medplib_tpu_torch.models import llama, medplib
    from medplib_tpu_torch.utils.convert import tree_to_numpy
    from medplib_tpu_torch.utils.quantize import quantize_tree
    cfg = tiny_serving_cfg(256, 4)
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, enable=False),
                     llm=dc.replace(cfg.llm, intermediate_size=512))
    p = medplib.init_medplib(torch.Generator().manual_seed(2), cfg,
                             torch.float32, "cpu")
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    p["llm"] = llama.pack_inference(p["llm"])
    host = tree_to_numpy(quantize_tree(p, bits=bits))
    kernel = "int8_matmul" if bits == 8 else "int4h_matmul"
    _tiny_card_vs_cpu(dev, f"small packed int{bits} check", cfg, host,
                      False, actq=bits == 8, **{kernel: 20})


def region_batch(cfg, b, t, rng, dev, seg=True):
    """benchmarks/run_all.py _vqa_batch(region=True) on make_batch's batch:
    a region marker at 4 with a g/3 x g/3 mask (g the CLIP grid side), the
    image sentinel expanding to the model's tokens per image; without
    `seg` no <SEG> in the prompt (pure VQA)."""
    import torch
    from medplib_tpu_torch.config import REGION_TOKEN_INDEX
    from medplib_tpu_torch.models.medplib import image_tokens_per_image
    batch = make_batch(cfg, b, t, rng, dev)
    ids = batch.input_ids.clone()
    ids[:, 4] = REGION_TOKEN_INDEX
    if not seg:
        ids[:, t - 3] = 9
    g = int(round(cfg.vision.num_patches ** 0.5))
    rm = torch.zeros((b, 1, g, g), device=dev)
    rm[:, :, : max(1, g // 3), : max(1, g // 3)] = 1.0
    return batch._replace(
        input_ids=ids, region_masks=rm,
        region_valid=torch.ones_like(batch.region_valid),
        image_token_lengths=torch.full_like(batch.image_token_lengths,
                                            image_tokens_per_image(cfg)))


def icl_mask_batch(cfg, b, t, rng, dev):
    """Three image slots per row (query + 2 in-context examples), the last
    an example MASK for the mask encoder (image_is_mask), <SEG> at T-3."""
    import torch
    batch = make_icl_batch(cfg, b, t, rng, dev)
    ms = cfg.projector.mask_input_size
    is_mask = torch.zeros_like(batch.image_token_lengths)
    is_mask[:, 2] = 1
    lens = torch.full_like(batch.image_token_lengths,
                           cfg.projector.compress_tokens)
    lens[:, 2] = cfg.projector.mask_encoder_tokens
    masks = torch.as_tensor((rng.uniform(size=(b, 3, ms, ms)) > 0.5).astype(
        np.float32)).to(dev)
    return batch._replace(image_token_lengths=lens, image_is_mask=is_mask,
                          mask_images=masks)


def small_region_checks(dev):
    """The region / ICL / sampling modules card vs CPU on the tiny MoE model
    (f32, no quantization; B <= 4, so no kernel launches): region VQA with
    the adapter and with the geo sampler, the ICL compressor with the mask
    encoder, sampled decode from the same per-row seeds (the streams' keys
    must be equal on both); then the geo sampler's point sampling, FPS and
    kNN indices at full width (1024-d CLIP features, 24 x 24 masks, B·M =
    16), which must be equal, and its output within 1e-4."""
    import dataclasses as dc

    import torch
    from medplib_tpu_torch import config as C
    from medplib_tpu_torch.models import geo_sampler, medplib
    from medplib_tpu_torch.ops import sampling
    from medplib_tpu_torch.utils.convert import tree_to_numpy

    def tree(cfg, seed):
        p = medplib.init_medplib(torch.Generator().manual_seed(seed), cfg,
                                 torch.float32, "cpu")
        p["llm"]["embed_tokens"]["embedding"] *= 50.0
        return tree_to_numpy(p)

    base = tiny_serving_cfg(256, 4)
    for geo in (False, True):
        cfg = dc.replace(base, projector=dc.replace(
            base.projector, region_adapter=True, region_geo_sampler=geo))
        _tiny_card_vs_cpu(
            dev, f"small region check ({'geo sampler' if geo else 'adapter'})",
            cfg, tree(cfg, 4), False, actq=False,
            make=lambda w, c=cfg: region_batch(c, 3, 16,
                                               np.random.default_rng(1), w),
            gen_kw=dict(rp_flag=True))
    icfg = C.with_icl(base, token_compress=True, mask_encoder=True)
    _tiny_card_vs_cpu(
        dev, "small ICL compressor + mask encoder check", icfg,
        tree(icfg, 5), False, actq=False,
        make=lambda w: icl_mask_batch(icfg, 2, 16, np.random.default_rng(2),
                                      w))
    seeds = [3, 1, 4, 1]
    keys = [sampling.row_keys(seeds, 4, w) for w in ("cpu", dev)]
    if not torch.equal(keys[0], keys[1].cpu()):
        raise AssertionError("the sampling streams' keys differ on the card")
    g = [sampling.gumbel_rows(k, 1000).cpu() for k in keys]
    log(f"[small sampled check] per-row keys equal on the card; Gumbel "
        f"noise max abs diff {float((g[0] - g[1]).abs().max()):.2e}")
    _tiny_card_vs_cpu(
        dev, "small sampled check", base, tree(base, 6), False, actq=False,
        make=lambda w: make_batch(base, 4, 16, np.random.default_rng(3), w),
        gen_kw=dict(do_sample=True, temperature=torch.tensor(
            [0.8, 1.0, 0.0, 1.3]), top_p=0.9, rng=seeds))

    # the geo sampler at full width
    rng = np.random.default_rng(7)
    b, m, gs, c = 4, 4, 24, 1024
    masks = (rng.uniform(size=(b, m, gs, gs))
             > rng.uniform(0.2, 0.97, size=(b, m, 1, 1))).astype(np.float32)
    masks[0, 0] = 1.0
    fmap = rng.normal(size=(b, gs * gs, c)).astype(np.float32)
    params = geo_sampler.init_geo_sampler(torch.Generator().manual_seed(8),
                                          c, 4096, device="cpu")
    runs = {}
    for where in ("cpu", dev):
        mk = torch.as_tensor(masks).to(where)
        pts = geo_sampler.sample_mask_points(mk.reshape(b * m, gs, gs), 512)
        idx = [pts]
        for nsub in (128, 32):
            f = geo_sampler.farthest_point_sample(pts, nsub)
            new = torch.gather(pts, 1, f[..., None].expand(-1, -1, 2))
            idx += [f, geo_sampler.knn(pts, new, 24)]
            pts = new
        out = geo_sampler.apply_geo_sampler(
            _to(params, where), torch.as_tensor(fmap).to(where), mk,
            torch.ones((b, m), dtype=torch.bool, device=where))
        runs[str(where)] = ([x.cpu() for x in idx], out.cpu())
    (ic, oc), (ig, og) = runs["cpu"], runs[str(dev)]
    same = {n: torch.equal(x, y) for n, x, y in zip(
        ("points", "FPS 128", "kNN 24 of 512", "FPS 32", "kNN 24 of 128"),
        ic, ig)}
    eq = all(same.values())
    orel = rel_err(og, oc)
    log(f"[small geo check] B·M={b * m} masks 24 x 24, 1024-d features, "
        f"card vs CPU equal: {same}; output rel err {orel:.3e} (<= 1e-4)")
    if not eq or orel > 1e-4:
        raise AssertionError("the geo sampler disagrees with the CPU")


def _to(tree, where):
    from medplib_tpu_torch.utils import tree as tree_util
    return tree_util.unflatten(tree, [x.to(where)
                                      for x in tree_util.leaves(tree)])


def qlora_params(cfg, gen, dtype, dev, lora_b_scale=0.0):
    """The stage-3 QLoRA tree (benchmarks/run_all.py bench_train): init in
    `dtype`, the LLM int8-quantized, LoRA r=8 on q_proj / v_proj; with
    lora_b_scale > 0 a random lora_b, so the adapters are live."""
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops.initializers import normal
    from medplib_tpu_torch.train import lora
    from medplib_tpu_torch.utils import quantize as qz
    params = medplib.init_medplib(gen, cfg, dtype, dev)
    params["llm"] = qz.quantize_tree(params["llm"])
    params["llm"] = lora.inject(gen, params["llm"], ("q_proj", "v_proj"),
                                r=8)
    if lora_b_scale:
        for n in ("q_proj", "v_proj"):
            node = params["llm"]["layers"]["attn"][n]
            node["lora_b"] = normal(gen, node["lora_b"].shape,
                                    node["lora_b"].dtype, dev, lora_b_scale)
    return params


def tiny_train_cfg(moe=None):
    """The tiny model of the card-vs-CPU train checks: 2 layers of
    head_dim 128 (the flash route), tiny CLIP (16 patches) and SAM; with
    `moe` a MoeConfig for the LLM."""
    from medplib_tpu_torch import config as C
    llm = C.LlamaConfig(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=2,
                        num_kv_heads=2, head_dim=128)
    return C.MedplibConfig(
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
        projector=C.ProjectorConfig(mm_hidden_size=64, hidden_size=256),
        moe=moe or C.MoeConfig(), seg=C.SegConfig(out_dim=32),
        seg_token_idx=500, vocab_size_padded=512)


def train_check(dev):
    """Two make_train_step steps of a tiny QLoRA model on the card (flash
    kernels, since head_dim is 128 and the spliced row has 1039 >= 1024
    tokens) and on the CPU (plain attention), from the same f32 params
    and batch, LoRA dropout 0. Losses agree within 1e-4 relative (f32 sums
    in another order, flash vs plain softmax); the LoRA updates of step 2
    within 1e-2 relative Frobenius (Adam's normalized step amplifies the
    noise of near-zero gradients; the bf16 adapters round it)."""
    import torch
    from medplib_tpu_torch import config as C
    from medplib_tpu_torch.models.medplib import Batch
    from medplib_tpu_torch.train import trainer
    from medplib_tpu_torch.utils import tree as tree_util
    cfg = tiny_train_cfg()
    tcfg = C.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         lora_dropout=0.0)
    host = qlora_params(cfg, torch.Generator().manual_seed(3), torch.float32,
                        "cpu", 0.02)
    runs = {}
    for where in ("cpu", dev):
        params = tree_util.unflatten(
            host, [x.to(where) for x in tree_util.leaves(host)])
        b = make_batch(cfg, 2, 1024, np.random.default_rng(5), where)
        state, tx = trainer.create_state(params, tcfg)
        step = trainer.make_train_step(cfg, tcfg, tx)
        batches = Batch(*[x[None] for x in b])
        reset_counts()
        losses = []
        for _ in range(2):
            state, m = step(state, batches)
            losses.append(float(m["loss"]))
        runs[str(where)] = (losses, flash_counts(), params, state.params)
    (lc, nc, p0, pc), (lg, ng, _, pg) = runs["cpu"], runs[str(dev)]
    num = den = 0.0
    for (path, a), o, g in zip(tree_util.leaves_with_paths(pc),
                               tree_util.leaves(p0), tree_util.leaves(pg)):
        if path[-1] in ("lora_a", "lora_b"):
            da, dg = (a - o).float(), (g.cpu() - o).float()
            num += float(((dg - da) ** 2).sum())
            den += float((da ** 2).sum())
    lrel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    urel = (num / den) ** 0.5 if den else float("inf")
    want = (2 * 2 * 2, 2 * 2, 2 * 2)    # layers x (fwd + remat) x steps
    log(f"[train check] tiny QLoRA, B=2 x 1039 tokens, 2 steps, card vs "
        f"CPU: losses {lg} vs {lc} (max rel {lrel:.2e} <= 1e-4), LoRA "
        f"update rel {urel:.2e} (<= 1e-2); flash launches {ng} (want "
        f"{want}), CPU {nc}")
    if lrel > 1e-4 or urel > 1e-2 or ng != want or nc != (0, 0, 0):
        raise AssertionError("tiny train step disagrees with the CPU")


def _int8_fingerprint(params):
    """-> [(path, int64 sum of the leaf's bytes read as int32 words)] over
    every int8 leaf, 64 MiB at a time."""
    import torch
    from medplib_tpu_torch.utils import tree as tree_util
    out = []
    for path, x in tree_util.leaves_with_paths(params):
        if x.dtype == torch.int8:
            words = x.reshape(-1).view(torch.int32)
            out.append((path, sum(int(c.sum(dtype=torch.int64))
                                  for c in words.split(1 << 24))))
    return out


# --profiles turns on the profiled calls that no metric of PERF.md reads
# (each kernel phase's, the side paths'); the main path's and the engine's
# decode chunk are always profiled
PROFILES = False


def profile_step(fn, top: int = 14, always: bool = False) -> None:
    """One call of `fn` under utils/profiling.trace (host + CUDA): prints
    the wall time, the summed time of the device's kernels (on one stream
    they do not overlap, so 1 - sum / wall is the device's idle share),
    the kernels that take the most of it and the seconds the whole
    profile cost. Runs only with `always` or under --profiles."""
    if not (always or PROFILES):
        return
    import torch
    from medplib_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    t_all = time.time()
    with profiling.trace(None) as prof:
        with profiling.span("profile_step"):
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
    busy, stalls, rows = profiling.kernel_summary(prof)
    log(f"[profile] wall {wall:.3f} s under the profiler, kernels "
        f"{busy:.3f} s (idle share {max(0.0, 1 - busy / wall):.3f}; "
        f"'Command Buffer Full' {stalls:.3f} s); {time.time() - t_all:.1f}"
        f" s with the profiler's own work; top kernels:")
    for us, n, key in rows[:top]:
        log(f"[profile]   {us / 1e3:9.1f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{n:6d} x  {key[:110]}")


def train_phase(dev, results, card, keep=None):
    """The stage-3 QLoRA train step at full width (bench_train's config):
    dense LLaMA-7B + CLIP ViT-L/14-336 + SAM-Med2D ViT-B, bf16 init on the
    card from a seeded generator, the LLM int8, LoRA q/v r=8 with dropout
    0.05, B=8 x T_in=512 (1087 spliced tokens), remat; one warm-up step
    and three timed ones (host clock ending in a synchronize). A `keep`
    dict receives the tree as it was before the first step ("params",
    for dist_train_stage3)."""
    import torch
    import torch.nn.functional as F
    from medplib_tpu_torch.config import TrainConfig, flagship_cfg
    from medplib_tpu_torch.models.medplib import Batch
    from medplib_tpu_torch.train import trainer

    cfg = flagship_cfg(32, moe=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = qlora_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          torch.bfloat16, dev)
    torch.cuda.synchronize()
    log(f"[train] dense 7B QLoRA initialized in {time.time() - t0:.1f} s; "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, T = 8, 512
    b = make_batch(cfg, B, T, np.random.default_rng(0), dev)
    batches = Batch(*[x[None] for x in b])
    spliced = T - 1 + cfg.vision.num_patches
    tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=100)
    state, tx = trainer.create_state(params, tcfg)
    step = trainer.make_train_step(cfg, tcfg, tx)
    if keep is not None:
        keep["params"] = params
    before = _int8_fingerprint(state.params)
    lora_b0 = state.params["llm"]["layers"]["attn"]["q_proj"]["lora_b"]

    sdpa_calls = []
    real_sdpa = F.scaled_dot_product_attention

    def counting_sdpa(*a, **k):
        sdpa_calls.append(1)
        return real_sdpa(*a, **k)

    F.scaled_dot_product_attention = counting_sdpa
    try:
        reset_counts()
        t0 = time.time()
        state, m = step(state, batches)
        loss = float(m["loss"])
        t_warm = time.time() - t0
        per_step = flash_counts()
        losses, times = [loss], []
        for _ in range(3):
            t0 = time.time()
            state, m = step(state, batches)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            losses.append(float(m["loss"]))
        counts = flash_counts()
    finally:
        F.scaled_dot_product_attention = real_sdpa
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = sum(times) / len(times)
    L = cfg.llm.num_layers
    want = (2 * L, L, L)
    lora_b = state.params["llm"]["layers"]["attn"]["q_proj"]["lora_b"]
    frozen_ok = _int8_fingerprint(state.params) == before
    log(f"[train] B={B} x {spliced} tokens: warm-up step {t_warm:.2f} s, "
        f"steps {', '.join(f'{t:.3f}' for t in times)} s -> "
        f"{B * spliced / dt:.1f} tokens/s; peak allocated {peak:.2f} GiB on "
        f"{card}")
    log(f"[train] losses {losses}; flash launches per step {per_step} "
        f"(want {want}), over 4 steps {counts}; int8 base unchanged "
        f"{frozen_ok}; LoRA lora_b moved {bool(lora_b.any())} (was "
        f"{bool(lora_b0.any())}); SDPA calls {len(sdpa_calls)}")
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError("non-finite training loss")
    if per_step != want or counts != tuple(4 * w for w in want):
        raise AssertionError("the train step did not run the flash kernels "
                             "as expected")
    if not frozen_ok or not bool(lora_b.any()) or sdpa_calls:
        raise AssertionError("frozen base changed, LoRA did not move, or "
                             "SDPA ran on the path")
    for name, n in zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                       counts):
        results[name]["launches"] = n
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batches)

    profile_step(one_step)
    return B * spliced / dt, peak


def skew_router(params, embed_shift=4.0, router_shift=3.0):
    """Every token embedding shares a large feature that each router
    weights toward expert 0, so top-1 routing at capacity 1.5 drops
    tokens (in place)."""
    llm = params["llm"]
    llm["embed_tokens"]["embedding"][:, 0] += embed_shift
    llm["layers"]["moe"]["router"]["kernel"][:, 0, 0] += router_shift


@contextlib.contextmanager
def count_drops():
    """-> list that collects the tokens each sort dispatch drops."""
    from medplib_tpu_torch.ops import moe
    real, seen = moe.sort_dispatch, []

    def counting(logits, k, capacity):
        d = real(logits, k, capacity)
        seen.append(d.token_slot >= logits.shape[1] * capacity)
        return d

    moe.sort_dispatch = counting
    try:
        yield seen
    finally:
        moe.sort_dispatch = real


def moe_train_check(dev):
    """Two make_train_step steps of a tiny stage-4-style model on the card
    and on the CPU from the same f32 params and batch: 2 layers of head
    dim 128 (a 1039-token spliced row takes K4-K6 on the card), moe_mode
    sparse (layer 0 MoE, layer 1 dense), Residual-MoE, top-1 at capacity
    1.5 with a skewed router so that tokens drop, LoRA q/v r=8 with a live
    lora_b, dropout 0, remat; the dropped tokens counted on each side
    (within 1%: a near-tied image token may route otherwise). Losses
    within 1e-4 relative (the card's sort
    combine adds with index_add_, whose order on CUDA is not fixed, and
    flash vs plain softmax); LoRA updates of step 2 within 1e-2 relative
    Frobenius, as train_check."""
    import torch
    from medplib_tpu_torch import config as C
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.models.medplib import Batch
    from medplib_tpu_torch.ops.initializers import normal
    from medplib_tpu_torch.train import lora, trainer
    from medplib_tpu_torch.utils import tree as tree_util
    cfg = tiny_train_cfg(C.MoeConfig(enable=True, num_experts=2, top_k=1,
                                     capacity_factor=1.5, moe_mode="sparse",
                                     use_residual=True))
    tcfg = C.TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                         lora_dropout=0.0)
    gen = torch.Generator().manual_seed(4)
    host = medplib.init_medplib(gen, cfg, torch.float32, "cpu")
    skew_router(host)
    host["llm"] = lora.inject(gen, host["llm"], ("q_proj", "v_proj"), r=8)
    for n in ("q_proj", "v_proj"):
        node = host["llm"]["layers"]["attn"][n]
        node["lora_b"] = normal(gen, node["lora_b"].shape, torch.float32,
                                "cpu", 0.02)
    runs = {}
    for where in ("cpu", dev):
        params = _to(host, where)
        b = make_batch(cfg, 2, 1024, np.random.default_rng(6), where)
        state, tx = trainer.create_state(params, tcfg)
        step = trainer.make_train_step(cfg, tcfg, tx)
        batches = Batch(*[x[None] for x in b])
        reset_counts()
        losses = []
        with count_drops() as dropped:
            for _ in range(2):
                state, m = step(state, batches)
                losses.append(float(m["loss"]))
        drops = sum(int(d.sum()) for d in dropped)
        runs[str(where)] = (losses, kernel_counts(), params, state.params,
                            drops)
    (lc, kc, p0, pc, dc), (lg, kg, _, pg, dg) = runs["cpu"], runs[str(dev)]
    num = den = 0.0
    for (path, a), o, g in zip(tree_util.leaves_with_paths(pc),
                               tree_util.leaves(p0), tree_util.leaves(pg)):
        if path[-1] in ("lora_a", "lora_b"):
            da, dg_ = (a - o).float(), (g.cpu() - o).float()
            num += float(((dg_ - da) ** 2).sum())
            den += float((da ** 2).sum())
    lrel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    urel = (num / den) ** 0.5 if den else float("inf")
    log(f"[moe train check] tiny sparse Residual-MoE, top-1 cap 1.5, B=2 x "
        f"1039 tokens, 2 steps, card vs CPU: losses {lg} vs {lc} (max rel "
        f"{lrel:.2e} <= 1e-4), LoRA update rel {urel:.2e} (<= 1e-2); tokens "
        f"dropped {dg} on the card, {dc} on the CPU")
    expect_counts("moe train check, card", kg, flash_fwd=8, flash_bwd_dq=4,
                  flash_bwd_dkv=4)
    expect_counts("moe train check, CPU", kc)
    if lrel > 1e-4 or urel > 1e-2 or not dg or abs(dg - dc) > 0.01 * dc:
        raise AssertionError("tiny MoE train step disagrees with the CPU")


def _bits_fingerprint(tensors):
    """int64 sum of each tensor's bytes read as int32 words, 64 MiB at a
    time."""
    import torch
    out = []
    for x in tensors:
        words = x.reshape(-1).view(torch.int32)
        out.append(sum(int(c.sum(dtype=torch.int64))
                       for c in words.split(1 << 24)))
    return out


def init_stage4(cfg, gen, dev):
    """The stage-4 starting tree (scripts/train_stage4.sh) in bf16 on the
    card: the dense skeleton without its MLP (every layer is MoE), expert
    e of every layer from donor e's dense MLP stack (build_experts_from_
    donors; the donors are random stacks from the seeded generator), a
    random router."""
    import torch
    from medplib_tpu_torch.config import MoeConfig
    from medplib_tpu_torch.models import llama, medplib, moe_llama
    from medplib_tpu_torch.ops.initializers import normal
    bf = torch.bfloat16
    params = medplib.init_medplib(
        gen, dataclasses.replace(cfg, moe=MoeConfig()), bf, dev)
    params["llm"] = moe_llama.strip_dense_mlp(params["llm"], cfg.llm, cfg.moe)
    L, E, H = cfg.llm.num_layers, cfg.moe.num_experts, cfg.llm.hidden_size
    donors = [llama.init_mlp(gen, cfg.llm, bf, dev, (L,)) for _ in range(E)]
    experts = moe_llama.build_experts_from_donors(donors)
    del donors
    params["llm"]["layers"]["moe"] = {
        "router": {"kernel": normal(gen, (L, H, E), bf, dev, H ** -0.5)},
        "experts": experts}
    return params


def moe_train_phase(dev, card, layers=32, keep_params=False):
    """Stage 4 at full width and depth: MedPLIB-7b-2e (32 layers x 2
    experts, top-1, capacity 1.5, router aux 0.01) in bf16 from
    init_stage4, LoRA q/v r=8 with dropout 0.05, the CLI's default sft
    modules, through Trainer's step: B=4 x T_in=512 (1087 spliced tokens)
    x ga 8, remat. One warm-up step (aux losses read there) and two timed
    ones (host clock ending in a synchronize), one profiled step; then
    Trainer.validate over two B=4 batches (eval capacity 2.0 covers every
    row: the per-layer grouped matmul, K3 in its bf16 float mode). The
    tree is not checkpointed (it would write ~26 GB). `layers` cuts the
    depth (the card tests run 2). With keep_params the trained tree
    (without the optimizer state) is returned as "params" for
    export_path."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F
    from medplib_tpu_torch.config import TrainConfig, flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.models.medplib import Batch
    from medplib_tpu_torch.train import lora, trainer
    from medplib_tpu_torch.utils import tree as tree_util

    cfg = flagship_cfg(layers, moe=True)
    L = cfg.llm.num_layers
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_stage4(cfg, gen, dev)
    params["llm"] = lora.inject(gen, params["llm"], ("q_proj", "v_proj"),
                                r=8)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in tree_util.leaves(params))
    log(f"[moe train] stage-4 7b-2e bf16 ({n_par / 1e9:.3f} B parameters) "
        f"initialized in {time.time() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, T, GA = 4, 512, 8
    spliced = T - 1 + cfg.vision.num_patches
    rng = np.random.default_rng(0)
    micro = [make_batch(cfg, B, T, rng, dev) for _ in range(GA)]
    batches = Batch(*[torch.stack(xs) for xs in zip(*micro)])
    del micro
    tcfg = TrainConfig(lr=1e-4, warmup_steps=1, total_steps=100,
                       grad_accumulation_steps=GA, lora_dropout=0.05)
    log_dir = tempfile.mkdtemp(prefix="moe_train_")
    try:
        tr = trainer.Trainer(cfg, tcfg, params, log_dir)
        del params
        experts = tr.state.params["llm"]["layers"]["moe"]["experts"]
        ex_tensors = [experts[n]["kernel"] for n in sorted(experts)]
        before = _bits_fingerprint(ex_tensors)
        lora_b0 = tr.state.params["llm"]["layers"]["attn"]["q_proj"][
            "lora_b"].clone()

        sdpa_calls, auxes = [], []
        real_sdpa, real_fwd = (F.scaled_dot_product_attention,
                               medplib.moe_llama.forward)

        def counting_sdpa(*a, **k):
            sdpa_calls.append(1)
            return real_sdpa(*a, **k)

        def aux_fwd(*a, **k):
            out = real_fwd(*a, **k)
            auxes.append(out[2].detach())
            return out

        F.scaled_dot_product_attention = counting_sdpa
        try:
            reset_counts()
            medplib.moe_llama.forward = aux_fwd
            t0 = time.time()
            tr.state, m = tr.step_fn(tr.state, batches)
            loss = float(m["loss"])
            t_warm = time.time() - t0
            medplib.moe_llama.forward = real_fwd
            per_step = kernel_counts()
            losses, times = [loss], []
            for _ in range(2):
                t0 = time.time()
                tr.state, m = tr.step_fn(tr.state, batches)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                losses.append(float(m["loss"]))
            counts = kernel_counts()
        finally:
            F.scaled_dot_product_attention = real_sdpa
            medplib.moe_llama.forward = real_fwd
        peak = torch.cuda.max_memory_allocated() / 2**30
        dt = sum(times) / len(times)
        tok_s = GA * B * spliced / dt
        aux = [float(a) for a in auxes]
        lora_b = tr.state.params["llm"]["layers"]["attn"]["q_proj"]["lora_b"]
        frozen_ok = _bits_fingerprint(ex_tensors) == before
        moved = not torch.equal(lora_b, lora_b0)
        log(f"[moe train] B={B} x {spliced} tokens x ga {GA}: warm-up step "
            f"{t_warm:.2f} s, steps {', '.join(f'{t:.3f}' for t in times)} "
            f"s -> {tok_s:.1f} tokens/s; peak allocated {peak:.2f} GiB on "
            f"{card}")
        log(f"[moe train] losses {losses}; router aux (sum over layers) per "
            f"microbatch {[round(a, 4) for a in aux]}; bf16 experts "
            f"unchanged {frozen_ok}; lora_b moved {moved}; SDPA calls "
            f"{len(sdpa_calls)}")
        expect_counts("moe train step", per_step, flash_fwd=GA * 2 * L,
                      flash_bwd_dq=GA * L, flash_bwd_dkv=GA * L)
        expect_counts("moe train, 3 steps", counts, flash_fwd=3 * GA * 2 * L,
                      flash_bwd_dq=3 * GA * L, flash_bwd_dkv=3 * GA * L)
        if not all(np.isfinite(x) for x in losses + aux) or len(aux) != GA:
            raise AssertionError("non-finite stage-4 loss or aux loss")
        if not frozen_ok or not moved or sdpa_calls:
            raise AssertionError("frozen experts changed, LoRA did not move, "
                                 "or SDPA ran on the path")

        def one_step():
            tr.state, _ = tr.step_fn(tr.state, batches)

        profile_step(one_step)
        del batches
        val = [make_batch(cfg, B, T, np.random.default_rng(100 + i), dev)
               for i in range(2)]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        vres = tr.validate(iter(val))
        torch.cuda.synchronize()
        val_s = (time.time() - t0) / len(val)
        vcounts = kernel_counts()
        log(f"[moe validate] 2 batches of B={B} x {spliced} tokens: "
            f"{val_s:.3f} s/batch; {vres}")
        expect_counts("moe validate", vcounts, gmm=2 * 3 * L,
                      flash_fwd=2 * L)
        if not all(np.isfinite(v) for v in vres.values()):
            raise AssertionError("non-finite validation metrics")
        trained = tr.state.params if keep_params else None
        del tr, val
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    log(f"[moe train] phase done in {time.time() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return {"tok_s": tok_s, "peak": peak, "val_s": val_s, "aux": aux,
            "losses": losses, "params": trained, **vres}


# ---------------------------------------------------------------------------
# export path: the trained stage-4 tree merged, exported and served
# ---------------------------------------------------------------------------

# Merged vs unmerged teacher-forced logits of a bf16 tree with random
# weights. Any bf16-level change of the q / v kernels moves them: the
# logits are bf16 (ulp 1/32 at the top logits of a 32320-entry
# vocabulary, whose top-2 gaps are ~0.2), and top-1 routing flips tokens
# between experts. scripts/merge_hold_cpu.py measured on the CPU (bf16,
# 2 experts, vocabulary 32320, width 512, 32 layers): merged vs unmerged
# rel err 4.4e-2, top-1 agreement 0.934, while the unmerged tree's own
# bf16 logits sit 5.2e-2 / 0.927 from its f32 logits. The tolerances
# below are about twice that noise; the merge itself is held element by
# element (merge_kernel_hold).
MERGE_REL_TOL = 1e-1
MERGE_MIN_AGREE = 0.85


def merge_kernel_hold(unmerged, merged, names=("q_proj", "v_proj")):
    """Every merged q / v element against W + (A @ B) x 2 (transposed)
    computed in float32 from the unmerged tree, in units of
    2^-8 (|W + delta| + 2 |delta|): one bf16 rounding of the sum, one of
    A @ B and a margin for its float32 sum (bf16's unit roundoff is
    2^-8). -> the largest such ratio (<= 1 when the merge is right)."""
    import torch
    worst = 0.0
    for n in names:
        u = unmerged["llm"]["layers"]["attn"][n]
        m = merged["llm"]["layers"]["attn"][n]["kernel"]
        for i in range(m.shape[0]):           # one layer at a time
            delta = (u["lora_a"][i].float() @ u["lora_b"][i].float()
                     * 2.0).t()
            ref = u["kernel"][i].float() + delta
            bound = (ref.abs() + 2 * delta.abs()) * 2 ** -8
            err = (m[i].float() - ref).abs()
            worst = max(worst, float((err / (bound + 1e-30)).max()))
    return worst


def teacher_forced_logits(params, cfg, batch):
    """-> (f32 logits [B, S, V] of the spliced sequence, attention mask
    [B, S]) without dropout, eval capacity (Trainer.validate's forward
    without the SAM head)."""
    import torch
    from medplib_tpu_torch.models import llama, medplib
    with torch.no_grad():
        embeds, _, attn_mask, _, _ = medplib.splice_batch(params, cfg, batch)
        hidden, _, _ = medplib._llm_forward(params, cfg, embeds, attn_mask,
                                            train=False)
        return llama.logits(params["llm"], hidden), attn_mask


def merge_hold(unmerged, merged, cfg, batch):
    """-> (norm-relative error of the merged tree's teacher-forced logits
    against the unmerged tree's, share of equal top-1 ids over the
    attended positions)."""
    lu, am = teacher_forced_logits(unmerged, cfg, batch)
    lm, _ = teacher_forced_logits(merged, cfg, batch)
    rel = float((lm - lu).norm() / lu.norm())
    keep = am.bool()
    agree = float((lm.argmax(-1) == lu.argmax(-1))[keep].float().mean())
    return rel, agree


def layer_slice(llm, n):
    """The first n layers of an LLM tree: views of the stacked
    ["layers"] leaves; the unstacked leaves as they are."""
    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return node[:n]
    return {k: (rec(v) if k == "layers" else v) for k, v in llm.items()}


def _same_leaves(got, want):
    """-> the paths where two trees differ (paths, dtype or values)."""
    import torch
    from medplib_tpu_torch.utils import tree as tree_util
    g, w = tree_util.leaves_with_paths(got), tree_util.leaves_with_paths(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        return [("paths differ",)]
    return [p for (p, a), (_, b) in zip(g, w)
            if a.dtype != b.dtype or a.shape != b.shape
            or not torch.equal(a.to(b.device), b)]


def export_cli_check(dev, cfg, merged, base_qv, layers=2):
    """utils/export's files and command line on the first `layers` layers
    of the merged full-width tree (views; CLIP and the ICL modules, which
    the merged export does not carry, left out), in a temp directory that
    is removed afterwards: save_params; `python -m
    medplib_tpu_torch.utils.export inspect` in a subprocess (its TOTAL =
    the tree's size); main(to-f32) (every leaf equal after widening);
    main(to-hf) with shards of a quarter of the tree (>= 2 shards and an
    index); main(
    from-reference) back (leaf-equal to what went out); make_delta
    against the unmerged q / v kernels (`base_qv`) and apply_delta back
    (the leaves the base lacks pass through; on q / v at most two bf16
    roundings of the delta's size off the merged kernel); consolidate
    (leaf-equal). -> seconds."""
    import shutil
    import tempfile

    import torch
    from medplib_tpu_torch.config import to_json
    from medplib_tpu_torch.models import moe_llama
    from medplib_tpu_torch.utils import export as ex
    from medplib_tpu_torch.utils import tree as tree_util
    from medplib_tpu_torch.utils.checkpoint import load_params, save_params

    t0 = time.time()
    small_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=layers))
    small = {k: merged[k] for k in ("mm_projector", "text_hidden_fcs", "sam",
                                    "region_fea_adapter") if k in merged}
    small["llm"] = layer_slice(merged["llm"], layers)
    n_el = sum(x.numel() for x in tree_util.leaves(small))
    n_bytes = sum(x.numel() * x.element_size()
                  for x in tree_util.leaves(small))
    d = tempfile.mkdtemp(prefix="export_cli_")
    try:
        P = lambda n: os.path.join(d, n)  # noqa: E731
        dv = ["--device", str(dev)]
        save_params(P("small.pt"), small)
        with open(P("cfg.json"), "w") as f:
            f.write(to_json(small_cfg))
        out = subprocess.run(
            [sys.executable, "-m", "medplib_tpu_torch.utils.export", *dv,
             "inspect", "--in-path", P("small.pt")], cwd=HERE,
            capture_output=True, text=True, timeout=600, check=True).stdout
        total = int(out.splitlines()[-1].split()[-1].replace(",", ""))
        if total != n_el:
            raise AssertionError(f"inspect TOTAL {total} != {n_el}")
        ex.main([*dv, "to-f32", "--in-path", P("small.pt"), "--out-path",
                 P("f32.pt")])
        f32 = load_params(P("f32.pt"), device=dev)
        os.unlink(P("f32.pt"))
        bad = [p for (p, a), (_, b) in zip(tree_util.leaves_with_paths(f32),
                                           tree_util.leaves_with_paths(small))
               if a.dtype != (torch.float32 if b.is_floating_point()
                              else b.dtype)
               or not torch.equal(a, b.to(a.dtype))]
        del f32
        ex.main([*dv, "to-hf", "--in-path", P("small.pt"), "--config",
                 P("cfg.json"), "--out-dir", P("hf"), "--shard-bytes",
                 str(n_bytes // 4)])
        shards = sorted(f for f in os.listdir(P("hf"))
                        if f.endswith(".safetensors"))
        with open(os.path.join(P("hf"), "model.safetensors.index.json")) as f:
            index = json.load(f)
        ex.main([*dv, "from-reference", "--hf-dir", P("hf"), "--config",
                 P("cfg.json"), "--out-path", P("back.pt")])
        shutil.rmtree(P("hf"))
        back = load_params(P("back.pt"), device=dev)
        back["llm"] = moe_llama.strip_dense_mlp(back["llm"], small_cfg.llm,
                                                small_cfg.moe)
        round_trip = _same_leaves(back, small)
        del back
        base = {"llm": layer_slice({"layers": base_qv}, layers)}
        delta = ex.make_delta(base, small)
        again = ex.apply_delta(base, delta)
        attn = delta["llm"]["layers"]["attn"]
        moved = [n for n in ("q_proj", "v_proj")
                 if bool(attn[n]["kernel"].any())]
        worst = 0.0
        for n in ("q_proj", "v_proj"):
            got = again["llm"]["layers"]["attn"][n]["kernel"].float()
            want = small["llm"]["layers"]["attn"][n]["kernel"].float()
            dlt = attn[n]["kernel"].float()
            worst = max(worst, float(((got - want).abs()
                                      / (dlt.abs() * 2 ** -7 + 1e-30)).max()))
            again["llm"]["layers"]["attn"][n]["kernel"] = small["llm"][
                "layers"]["attn"][n]["kernel"]
        delta_off_qv = _same_leaves(again, small)
        del delta, again
        ex.consolidate(P("small.pt"), P("cons.pt"), device=dev)
        cons = _same_leaves(load_params(P("cons.pt"), device=dev), small)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    dt = time.time() - t0
    log(f"[export cli] {layers}-layer full-width tree, {n_el / 1e9:.3f} B "
        f"elements, {n_bytes / 2**30:.2f} GiB: inspect TOTAL {total:,d}; "
        f"to-f32 unequal leaves {len(bad)}; to-hf {len(shards)} shards, "
        f"index of {len(index['weight_map'])} keys; from-reference unequal "
        f"leaves {len(round_trip)}; delta nonzero on {moved}, apply_delta "
        f"error / two bf16 roundings of the delta {worst:.3f}, other leaves "
        f"unequal {len(delta_off_qv)}; consolidate unequal {len(cons)}; "
        f"{dt:.1f} s")
    if bad or len(shards) < 2 or round_trip or moved != ["q_proj", "v_proj"] \
            or worst > 1.0 or delta_off_qv or cons:
        raise AssertionError("export CLI round trip failed")
    return dt


def export_decoder_check(dev, cfg, params, b=16):
    """export_seg_decoder at B=b on the card, run through
    torch.export.load, against a direct text_hidden_fcs +
    decode_seg_masks call on the same random SAM embeddings and <SEG>
    hidden states: mask logits and iou within 1% of the largest |value|
    (bf16; measured equal on the CPU in f32). -> (export seconds,
    largest relative error)."""
    import io

    import torch
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.export import export_seg_decoder
    k = params["text_hidden_fcs"]["fc1"]["kernel"]
    e, dd = cfg.sam.image_embedding_size, cfg.sam.prompt_embed_dim
    g = torch.Generator(device=dev).manual_seed(5)
    emb = torch.randn((b, e, e, dd), generator=g, device=dev).to(k.dtype)
    hid = torch.randn((b, 1, cfg.llm.hidden_size), generator=g,
                      device=dev).to(k.dtype)
    t0 = time.time()
    blob = export_seg_decoder(params, cfg, batch_size=b, num_segs=1)
    t_export = time.time() - t0
    prog = torch.export.load(io.BytesIO(blob)).module()
    with torch.no_grad():
        gm, gi = prog(params["sam"], params["text_hidden_fcs"], emb, hid)
        seg = medplib.text_hidden_fcs(params["text_hidden_fcs"], hid)
        dm, di = medplib.decode_seg_masks(params, cfg, emb, seg,
                                          cfg.sam.image_size)
    errs = [float((a.float() - w.float()).abs().max()
                  / w.float().abs().max()) for a, w in ((gm, dm), (gi, di))]
    log(f"[export decoder] B={b}: torch.export {t_export:.1f} s, "
        f"{len(blob) / 2**20:.2f} MiB; loaded program vs direct call: masks "
        f"{tuple(gm.shape)} max err / max |value| {errs[0]:.3e}, iou "
        f"{errs[1]:.3e}")
    if tuple(gm.shape) != (b, 1, cfg.sam.image_size, cfg.sam.image_size) \
            or max(errs) > 1e-2:
        raise AssertionError("the exported decoder disagrees")
    return t_export, max(errs)


def block_int4_check(dev, w):
    """The int4 "block" scheme at one full-width shape: w [K, N] (normal,
    an [in, out] node) and w.T (transposed, an [out, in] q_proj-style
    node), quantized on the card and on the CPU (the packed bytes and
    scales must be equal), then `linear` / `linear_t` on 64 f32 rows on
    each: norm-relative 1e-5 (f32 sums in other orders, TF32 off)."""
    import torch
    from medplib_tpu_torch.train import lora
    from medplib_tpu_torch.utils.quantize import quantize_tree
    out = {}
    x = torch.randn((64, w.shape[0]), generator=torch.Generator(
        ).manual_seed(6))
    for name, kern, fn in (("up_proj", w, lora.linear),
                           ("q_proj", w.t(), lora.linear_t)):
        nodes = {}
        for where in ("cpu", dev):
            tree = {name: {"kernel": kern.to(where).contiguous()}}
            nodes[str(where)] = quantize_tree(tree, skip=(), bits=4,
                                              int4_scheme="block")[name]
        c, g = nodes["cpu"], nodes[str(dev)]
        same = all(torch.equal(c[k], g[k].cpu()) for k in ("kernel",
                                                            "scale4"))
        yc = fn(c, x)
        yg = fn(g, x.to(dev)).cpu()
        rel = rel_err(yg, yc)
        out[name] = rel
        log(f"[block int4] {name} {tuple(kern.shape)} -> packed "
            f"{tuple(g['kernel'].shape)}, scale4 {tuple(g['scale4'].shape)}"
            f"; card = CPU bytes {same}; linear card vs CPU rel {rel:.2e}")
        if not same or rel > 1e-5:
            raise AssertionError("block int4 card and CPU disagree")
    return out


def export_path(dev, card, trained, main_masks_s, cfg=None):
    """The stage-4 tree that moe_train_phase trained (bf16 7b-2e, LoRA q/v
    with lora_b moved by its steps), exported and served:

    1. merge_lora; every merged q / v element within bf16 rounding of
       its float32 value (merge_kernel_hold); the merged tree's
       teacher-forced logits on the phase's first B=4 micro-batch (1087
       spliced tokens) against the unmerged tree's: norm-relative error
       <= MERGE_REL_TOL, top-1 agreement >= MERGE_MIN_AGREE (see there);
       the unmerged tree's references are dropped;
    2. the file tools and the command line on its first 2 layers
       (export_cli_check);
    3. export_seg_decoder at B=16 (export_decoder_check);
    4. the int4 block scheme at 4096 x 11008 on layer 0's expert-0
       gate_proj (block_int4_check);
    5. quantize_flagship_moe(expert_bits=4) and the main path's request:
       B=16, T_in=48, 10 new tokens, W8A8 / W4A8 prefill: K1 96 and K2
       320 a call (serve_batch), a repeat with equal tokens and masks;
       masks/s beside main_path's.
    `cfg` (default the 32-layer flagship) is the trained tree's config.
    -> dict of its numbers."""
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.export import merge_lora
    from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                                  quantize_flagship_moe)

    cfg = cfg or flagship_cfg(32, moe=True)
    L = cfg.llm.num_layers
    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    merged = merge_lora(trained)
    torch.cuda.synchronize()
    t_merge = time.time() - t0
    k_hold = merge_kernel_hold(trained, merged)
    tf = make_batch(cfg, 4, 512, np.random.default_rng(0), dev)
    rel, agree = merge_hold(trained, merged, cfg, tf)
    attn = trained["llm"]["layers"]["attn"]
    base_qv = {"attn": {n: {"kernel": attn[n]["kernel"]}
                        for n in ("q_proj", "v_proj")}}
    trained.clear()                     # the caller's tree: drop it
    del tf, attn
    torch.cuda.empty_cache()
    log(f"[export] merge_lora {t_merge:.2f} s; merged q / v elements vs "
        f"W + AB x 2 in f32: largest error {k_hold:.3f} of its bf16 "
        f"rounding bound; teacher-forced logits, B=4 x "
        f"{512 - 1 + cfg.vision.num_patches} tokens, merged vs unmerged: "
        f"rel err {rel:.3e} (tol {MERGE_REL_TOL}), top-1 agreement "
        f"{agree:.4f} (min {MERGE_MIN_AGREE}); allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if k_hold > 1.0 or not rel <= MERGE_REL_TOL or agree < MERGE_MIN_AGREE:
        raise AssertionError("the merged tree does not hold the unmerged "
                             "tree's logits")
    t_cli = export_cli_check(dev, cfg, merged, base_qv)
    del base_qv
    t_dec, dec_err = export_decoder_check(dev, cfg, merged)
    block_int4_check(dev, merged["llm"]["layers"]["moe"]["experts"][
        "gate_proj"]["kernel"][0, 0])

    t0 = time.time()
    params = quantize_flagship_moe(merged, expert_bits=4)
    del merged
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_quant = time.time() - t0
    log(f"[export] quantize_flagship_moe (int4h experts, int8 attention) "
        f"{t_quant:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, T, NEW = 16, 48, 10
    batch = make_batch(cfg, B, T, np.random.default_rng(0), dev)

    def run():
        with dynamic_act_quant(True):
            r = medplib.generate(params, cfg, batch, max_new_tokens=NEW)
        torch.cuda.synchronize()
        return r

    masks_s, peak, counts = serve_batch(
        "export", run, cfg, B, NEW, card, gmm_int4h=3 * L,
        moe_ffn_decode_int4h=L * NEW, flash_fwd=L)
    r1, r2 = run(), run()
    same = torch.equal(r1.output_ids, r2.output_ids) and torch.equal(
        r1.pred_masks, r2.pred_masks)
    log(f"[export] served merged tree B={B}: {masks_s:.3f} masks/s (main "
        f"path {main_masks_s:.3f} in this run); repeat equal tokens and "
        f"masks {same}; phase {time.time() - t_phase:.1f} s on {card}")
    if not same:
        raise AssertionError("export: repeated calls differ")
    del params, batch, r1, r2
    torch.cuda.empty_cache()
    return {"masks_s": masks_s, "peak": peak, "rel": rel, "agree": agree,
            "cli_s": t_cli, "export_s": t_dec,
            "phase_s": time.time() - t_phase}


def small_export_check(dev):
    """The export pipeline on the tiny int4h MoE serving model, card vs
    CPU: f32 init (unit-scale embeddings), LoRA q / v with a random
    lora_b, then on each device merge_lora -> quantize_flagship_moe ->
    generate (B=16 x T_in=64, 4 new tokens): tokens and masks as
    _tiny_card_vs_cpu holds them; K1 6, K2 8 on the card."""
    import torch
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops.initializers import normal
    from medplib_tpu_torch.train import lora
    from medplib_tpu_torch.utils.convert import tree_from_numpy, tree_to_numpy
    from medplib_tpu_torch.utils.export import merge_lora
    from medplib_tpu_torch.utils.quantize import quantize_flagship_moe
    cfg = tiny_serving_cfg(512, 8)
    gen = torch.Generator().manual_seed(1)
    p = medplib.init_medplib(gen, cfg, torch.float32, "cpu")
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    p["llm"] = lora.inject(gen, p["llm"], ("q_proj", "v_proj"), r=8)
    for n in ("q_proj", "v_proj"):
        node = p["llm"]["layers"]["attn"][n]
        node["lora_b"] = normal(gen, node["lora_b"].shape, torch.float32,
                                "cpu", 0.05)
    host = tree_to_numpy(p)

    def tree_at(where):
        return quantize_flagship_moe(merge_lora(tree_from_numpy(host, where)),
                                     4, 8)

    _tiny_card_vs_cpu(dev, "small export check", cfg, None, False,
                      tree_at=tree_at, gmm_int4h=6, moe_ffn_decode_int4h=8)


# ---------------------------------------------------------------------------
# MPT path
# ---------------------------------------------------------------------------

def small_mpt_check(dev):
    """A tiny MPT (MptConfig.tiny with ALiBi and no biases, as MPT-7B), f32
    params from a CPU generator copied to the card: greedy tokens (B=2,
    12-token prompt, 8 new) equal on the card and the CPU, the prompt's
    logits within 1e-4 absolute (f32, TF32 off). -> the largest logit
    difference."""
    import torch
    from medplib_tpu_torch.models import mpt
    from medplib_tpu_torch.utils.convert import tree_from_numpy, tree_to_numpy
    cfg = dataclasses.replace(mpt.MptConfig.tiny(), alibi=True,
                              learned_pos_emb=False, no_bias=True)
    host = tree_to_numpy(mpt.init_mpt(torch.Generator().manual_seed(3), cfg,
                                      torch.float32, "cpu"))
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))
    out = {}
    for where in ("cpu", dev):
        p = tree_from_numpy(host, where)
        x = torch.as_tensor(ids, device=where)
        logits, _ = mpt.forward(p, cfg, x)
        out[str(where)] = (logits.cpu(),
                           mpt.greedy_generate(p, cfg, x, 8).cpu())
    (lc, tc_), (lg, tg) = out["cpu"], out[str(dev)]
    err = float((lg - lc).abs().max())
    same = torch.equal(tc_, tg)
    log(f"[small mpt check] tiny ALiBi MPT card vs CPU: tokens equal {same}"
        f", logits max abs diff {err:.2e}")
    if not same or err > 1e-4:
        raise AssertionError("tiny MPT card and CPU disagree")
    return err


def mpt_path(dev, card):
    """MPT-7B at its published widths (models/mpt.mpt_7b_config: 4096 x 32
    heads x 32 layers, expansion 4, vocabulary 50432, ALiBi, no biases),
    bf16 params from a seeded generator on the card (~6.65 B, 13.3 GB);
    greedy_generate at B=4, a 64-token prompt, 16 new tokens: one warm-up
    call, two timed calls whose tokens must equal the warm-up's; no
    kernel of the port launches (attention and products are plain
    PyTorch, as the JAX package's are XLA). -> dict."""
    import torch
    from medplib_tpu_torch.models import mpt
    from medplib_tpu_torch.utils import tree as tree_util
    cfg = mpt.mpt_7b_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = mpt.init_mpt(torch.Generator(device=dev).manual_seed(0), cfg,
                          torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_par = sum(x.numel() for x in tree_util.leaves(params))
    log(f"[mpt] MPT-7B bf16 {n_par / 1e9:.3f} B parameters initialized in "
        f"{time.time() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, T, NEW = 4, 64, 16
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T)), device=dev)
    reset_counts()
    first = mpt.greedy_generate(params, cfg, ids, NEW)
    torch.cuda.synchronize()
    times, same = [], True
    for _ in range(2):
        t0 = time.time()
        toks = mpt.greedy_generate(params, cfg, ids, NEW)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        same = same and torch.equal(toks, first)
    expect_counts("mpt", kernel_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = sum(times) / len(times)
    tok_s = B * NEW / dt
    log(f"[mpt] greedy B={B} x {T} prompt tokens + {NEW} new: "
        f"{', '.join(f'{t:.3f}' for t in times)} s per call -> "
        f"{tok_s:.1f} new tokens/s; repeat tokens equal {same}; ids in "
        f"range {bool((first >= 0).all() and (first < cfg.vocab_size).all())}"
        f"; peak allocated {peak:.2f} GiB on {card}")
    if not same or tuple(first.shape) != (B, NEW):
        raise AssertionError("mpt: repeated greedy calls differ")
    del params
    torch.cuda.empty_cache()
    return {"tok_s": tok_s, "peak": peak, "s_call": dt}


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def check_result(r, cfg, b, new):
    """Token ids in range and finite mask logits of the expected shapes."""
    import torch
    assert r.output_ids.shape == (b, new)
    assert int(r.output_ids.min()) >= 0
    assert int(r.output_ids.max()) < cfg.vocab_size_padded
    s = cfg.sam.image_size
    assert tuple(r.pred_masks.shape) == (b, 1, s, s)
    assert bool(torch.isfinite(r.pred_masks.float()).all())


def serve_batch(name, run, cfg, b, new, card, **want):
    """One warm-up call (its launches checked), three timed calls with
    the warm-up's tokens; -> (masks/s, peak GiB, launches)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    first = run()
    t_first = time.time() - t0
    counts = kernel_counts()
    check_result(first, cfg, b, new)
    log(f"[{name}] batch B={b}: first call {t_first:.2f} s; has_seg "
        f"{first.has_seg.sum().item()}/{b}")
    expect_counts(name, counts, **want)
    rs, times = [], []
    for _ in range(3):       # host clock; `run` ends in a synchronize
        t0 = time.time()
        rs.append(run())
        times.append(time.time() - t0)
    if not all(torch.equal(r.output_ids, first.output_ids) for r in rs):
        raise AssertionError(f"{name}: a repeated batch call gave other "
                             f"tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = sum(times) / len(times)
    log(f"[{name}] batch B={b} max_new={new}: "
        f"{', '.join(f'{t:.3f}' for t in times)} s per call -> "
        f"{b / dt:.3f} masks/s, {dt * 1e3 / b:.1f} ms/sample; peak "
        f"allocated {peak:.2f} GiB on {card}")
    return b / dt, peak, counts


def serve_single(name, run, cfg, new, **want):
    """One B=1 request: its launches and its wall time."""
    reset_counts()
    t0 = time.time()
    one = run()
    t_one = time.time() - t0
    check_result(one, cfg, 1, new)
    log(f"[{name}] single request B=1: {t_one:.3f} s")
    expect_counts(name + " B=1", kernel_counts(), **want)


def main_path(dev, results, card):
    """The int4h-expert flagship: B=16 under W4A8 / W8A8 prefill (K1 at
    prefill, K2 at decode), one profiled call, then one request (sort
    prefill)."""
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib
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

    masks_per_s, peak, counts = serve_batch(
        "main", lambda: run(batch), cfg, B, NEW, card,
        gmm_int4h=3 * L, moe_ffn_decode_int4h=L * NEW, flash_fwd=L,
        moe_dispatch_quant=L, moe_swiglu_quant=L)
    for n in ("gmm_int4h", "moe_ffn_decode_int4h") + PREFILL_PASSES:
        results[n]["launches"] = counts[n]
    profile_step(lambda: run(batch), always=True)
    # B=1: 623 tokens take the capacity-sort prefill; decode still K2
    serve_single("main", lambda: run(single), cfg, NEW,
                 moe_ffn_decode_int4h=L * NEW, flash_fwd=L)
    return masks_per_s, peak, params


# ---------------------------------------------------------------------------
# serving engine (serve/engine.py): continuous batching, chunked prefill
# ---------------------------------------------------------------------------

class EngineTally:
    """What an engine or a worker dispatched: decode steps, whole-prompt
    prefills and the rows of each chunked-prefill extend (counted by
    wrapping the medplib functions they call; the package itself holds no
    counter)."""

    def __init__(self):
        self.steps = 0
        self.prefills = 0
        self.extends = []

    def k1_extends(self) -> int:
        """Extends of >= 1024 rows: the grouped matmul (K1) dispatch."""
        return sum(rows >= 1024 for rows in self.extends)


@contextlib.contextmanager
def engine_tally():
    """Count the decode steps and extends of the engine calls made inside
    the block."""
    from medplib_tpu_torch.models import medplib
    tally = EngineTally()
    dec, ext = medplib.stream_decode_chunk, medplib.stream_prefill_chunk
    pre = medplib.stream_prefill

    def count_dec(params, cfg, state, chunk, *a, **k):
        tally.steps += chunk
        return dec(params, cfg, state, chunk, *a, **k)

    def count_ext(params, cfg, carry, embeds, *a, **k):
        tally.extends.append(embeds.shape[0] * a[-1])
        return ext(params, cfg, carry, embeds, *a, **k)

    def count_pre(*a, **k):
        tally.prefills += 1
        return pre(*a, **k)

    medplib.stream_decode_chunk = count_dec
    medplib.stream_prefill_chunk = count_ext
    medplib.stream_prefill = count_pre
    try:
        yield tally
    finally:
        medplib.stream_decode_chunk = dec
        medplib.stream_prefill_chunk = ext
        medplib.stream_prefill = pre


def drain(r, timeout=600.0):
    """A request's token chunks, each read with a deadline; its error, if
    any, raises."""
    out = []
    while True:
        item = r.chunks.get(timeout=timeout)
        if item is None:
            if r.error is not None:
                raise r.error
            return out
        out.append(item)


def engine_request(cfg, i, t, rng, dev, seg=False):
    """run_all.py config 8 / 10's request: the bench batch at B=1 with
    ids[0, 5] = 100 + i and, unless `seg`, no <SEG> (pure VQA)."""
    b = make_batch(cfg, 1, t, rng, dev)
    ids = b.input_ids.clone()
    ids[0, 5] = 100 + i
    if not seg:
        ids[0, t - 3] = 7
    return b._replace(input_ids=ids)


def warm_engine(eng, b1):
    """config 8's warm-up: the engine's prefill at every power-of-2 batch
    <= slots (stream_prefill, or begin -> extends -> finish with
    prefill_chunk)."""
    import torch
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.serve.engine import _concat
    bucket = 1
    with torch.no_grad():
        while bucket <= eng.slots:
            b = _concat([b1] * bucket, eng.device)
            pc = eng.prefill_chunk
            if pc:
                e, am, sm, carry = medplib.stream_prefill_begin(
                    eng.params, eng.cfg, b, eng._cache_budget, pc,
                    kv_quant=eng.kv_quant)
                for ci in range(e.shape[1] // pc):
                    carry = medplib.stream_prefill_chunk(
                        eng.params, eng.cfg, carry, e, am, sm, ci * pc, pc)
                st = medplib.stream_prefill_finish(eng.params, eng.cfg,
                                                   carry, am)
            else:
                st = medplib.stream_prefill(eng.params, eng.cfg, b,
                                            eng._cache_budget,
                                            kv_quant=eng.kv_quant)
            st.tok.tolist()
            del st
            bucket *= 2


def expect_engine(name, eng, reqs, counts, tally, layers):
    """Every request ended without error, nothing is left active, and the
    kernels launched as the dispatched work says: K1 3 per layer for each
    extend of >= 1024 rows, K2 once per layer per decode step (<= 64
    slots), K4 once per layer per whole-prompt prefill at head_dim 128
    (the tiny head_dim-64 models take the plain attention)."""
    from medplib_tpu_torch.ops.cuda.flash_attention import HEAD_DIM
    flash = int(eng.cfg.llm.head_dim == HEAD_DIM)
    bad = [r.error for r in reqs if r.error is not None]
    if bad or eng.active_requests:
        raise AssertionError(f"{name}: errors {bad[:2]}, active "
                             f"{eng.active_requests}")
    expect_counts(f"{name} ({tally.steps} decode steps, {tally.prefills} "
                  f"prefills, extends {tally.extends})", counts,
                  gmm_int4h=3 * layers * tally.k1_extends(),
                  moe_ffn_decode_int4h=layers * tally.steps,
                  flash_fwd=layers * tally.prefills * flash)


def engine_wave(eng, batches, timeout=600.0):
    """Submit every request at once and drain them all -> (requests,
    tokens per request, seconds)."""
    t0 = time.time()
    reqs = [eng.submit(b, temperature=0.0) for b in batches]
    toks = [[t for c in drain(r, timeout) for t in c] for r in reqs]
    return reqs, toks, time.time() - t0


def stream_reference(params, cfg, batch, budget, chunk, kv_quant):
    """The B=1 stream path of one request -> (first token, the tokens of
    `budget` decode steps as the engine delivers them; none at 0)."""
    import torch
    from medplib_tpu_torch.models import medplib
    with torch.no_grad():
        st = medplib.stream_prefill(params, cfg, batch, budget,
                                    kv_quant=kv_quant)
        first = int(st.tok[0])
        toks, steps = [], 0
        while steps < budget:
            st, ct, cd = medplib.stream_decode_chunk(params, cfg, st, chunk)
            for t, d in zip(ct[0].tolist(), cd[0].tolist()):
                if not d and t > 0 and len(toks) < budget:
                    toks.append(t)
            steps += chunk
            if bool(cd[0, -1]) or bool(st.done[0]):
                break
    return first, toks


def engine_e1_e2(params, cfg, dev, card, group):
    """run_all.py config 8 with BENCH_ENGINE_MOE=1 on the int4h flagship:
    12 slots, 24 distinct greedy VQA requests (T_in=48, 623 spliced
    tokens, no <SEG>), 32 new tokens, decode chunks of 8, int8 KV. E1:
    per-request admission, run twice (the tokens must repeat), first
    tokens equal to a B=1 stream_prefill (whole streams compared with
    the B=1 stream path for the first 4 requests, reported), then two
    requests with <SEG> grounded. E2 (group): group_admission with
    prefill_chunk=256, so a group of 12 pads to 16 rows x 768 tokens:
    three extends of 4096 rows through K1 on bf16 x."""
    import torch
    from medplib_tpu_torch.serve.engine import BatchedEngine

    name = "E2" if group else "E1"
    slots, n_req, new, T, chunk = 12, 24, 32, 48, 8
    L = cfg.llm.num_layers
    rng = np.random.default_rng(0)
    eng = BatchedEngine(cfg, params, slots=slots, max_new_tokens=new,
                        chunk=chunk, kv_quant=True, group_admission=group,
                        prefill_chunk=256 if group else None)
    admits = []
    if group:
        admit = eng._admit

        def timed_admit(g):
            t0 = time.time()
            admit(g)
            admits.append((len(g), time.time() - t0))

        eng._admit = timed_admit
    out = {}
    try:
        t0 = time.time()
        warm_engine(eng, engine_request(cfg, 999, T, rng, dev))
        for r in [eng.submit(engine_request(cfg, 1000 + i, T, rng, dev),
                             temperature=0.0) for i in range(2)]:
            drain(r)
        log(f"[{name}] warm-up {time.time() - t0:.1f} s")
        batches = [engine_request(cfg, i, T, rng, dev) for i in range(n_req)]
        waves = 1 if group else 2
        runs = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(waves):
            admits.clear()
            reset_counts()
            with engine_tally() as tally:
                reqs, toks, dt = engine_wave(eng, batches)
            expect_engine(name, eng, reqs, kernel_counts(), tally, L)
            n_tok = sum(len(t) for t in toks)
            log(f"[{name}] {n_req} requests, {n_tok} tokens in {dt:.3f} s "
                f"-> {n_tok / dt:.3f} tok/s, {n_req / dt:.3f} req/s; "
                f"{tally.steps} decode steps, extends {tally.extends}")
            runs.append((toks, dt, n_tok, tally))
        peak = torch.cuda.max_memory_allocated() / 2**30
        toks, dt, n_tok, tally = runs[0]
        out.update(tok_s=n_tok / dt, req_s=n_req / dt, peak=peak)
        log(f"[{name}] peak allocated {peak:.2f} GiB on {card}")
        if group:
            if tally.k1_extends() < 1:
                raise AssertionError("E2: no extend of >= 1024 rows (K1)")
            big = [t for k, t in admits if k > 1]
            log(f"[E2] admissions (group size, s): {admits}")
            out["group_admit_s"] = max(big) if big else None
        else:
            if runs[1][0] != toks:
                raise AssertionError("E1: a repeated wave gave other tokens")
            # every first token against a B=1 prefill; whole streams (B=1
            # decode, ~3.5 s a request) for the first n_ref requests
            firsts, same, n_ref = [], 0, 4
            for k, (b, got) in enumerate(zip(batches, toks)):
                first, ref = stream_reference(
                    params, cfg, b, new if k < n_ref else 0, chunk, True)
                firsts.append(first == got[0])
                same += k < n_ref and ref == got
            log(f"[E1] first tokens equal to B=1 stream_prefill "
                f"{sum(firsts)}/{n_req}; whole streams equal to the B=1 "
                f"stream path {same}/{n_ref} (reported: decode at M = 1 "
                f"and M = {slots} may take other cuBLAS tiles)")
            if not all(firsts):
                raise AssertionError("E1: a first token differs from B=1")
            out["stream_equal"] = same / n_ref
            seg_reqs = [eng.submit(engine_request(cfg, 2000 + i, T, rng, dev,
                                                  seg=True),
                                   temperature=0.0) for i in range(2)]
            for r in seg_reqs:
                drain(r)
                masks, valid = r.ground()
                s = cfg.sam.image_size
                if (tuple(masks.shape) != (1, 1, s, s)
                        or not bool(torch.isfinite(masks).all())
                        or not bool(valid.all())):
                    raise AssertionError("E1: grounding gave bad masks")
            log(f"[E1] 2 <SEG> requests grounded: masks (1, 1, {s}, {s}) "
                f"finite")
        if eng.active_requests:
            raise AssertionError(f"{name}: requests left active")
    finally:
        eng.shutdown()
    return out


def engine_e3(params, cfg, dev, card):
    """run_all.py config 10's traffic (BENCH_TTFT_PREFILL_CHUNK=256) on
    the int4h flagship: 8 slots, int8 KV, decode chunks of 8; 7
    background greedy streams of 512 tokens, then 12 probes of 16 tokens
    (T_in=48) submitted one after another under that load. TTFT =
    submit -> first chunk at the client; the background streams' largest
    gap between chunk arrivals during the probes (ms, and in units of the
    median gap). A retired slot keeps decoding past its cache here."""
    import threading

    from medplib_tpu_torch.serve.engine import BatchedEngine

    slots, new, T, probes = 8, 512, 48, 12
    L = cfg.llm.num_layers
    rng = np.random.default_rng(0)
    eng = BatchedEngine(cfg, params, slots=slots, max_new_tokens=new,
                        chunk=8, kv_quant=True, prefill_chunk=256)
    try:
        drain(eng.submit(engine_request(cfg, 0, T, rng, dev),
                         temperature=0.0, max_new_tokens=8))
        gaps, started, probe_t0 = [], set(), [float("inf")]
        errors = []

        def consume(r):
            last, first = time.time(), True
            try:
                while True:
                    item = r.chunks.get(timeout=600)
                    if item is None:
                        break
                    now = time.time()
                    if first:
                        started.add(id(r))
                        first = False
                    if last >= probe_t0[0]:
                        gaps.append(now - last)
                    last = now
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        reset_counts()
        with engine_tally() as tally:
            bg = [eng.submit(engine_request(cfg, 1 + i, T, rng, dev),
                             temperature=0.0, max_new_tokens=new)
                  for i in range(slots - 1)]
            threads = [threading.Thread(target=consume, args=(r,),
                                        daemon=True) for r in bg]
            for t in threads:
                t.start()
            deadline = time.time() + 300
            while len(started) < slots - 1:
                if time.time() > deadline or any(r.error for r in bg):
                    raise AssertionError("E3: the background load did not "
                                         "start")
                time.sleep(0.05)
            probe_t0[0] = time.time()
            ttfts, preqs = [], []
            for i in range(probes):
                t0 = time.time()
                r = eng.submit(engine_request(cfg, 100 + i, T, rng, dev),
                               temperature=0.0, max_new_tokens=16)
                if r.chunks.get(timeout=600) is None:
                    raise AssertionError(f"E3: probe {i} failed: "
                                         f"{r.error!r}")
                ttfts.append(time.time() - t0)
                r.cancel()
                drain(r)
                preqs.append(r)
            for r in bg:
                r.cancel()
            for t in threads:
                t.join(timeout=600)
            stall_steps = tally.steps
        if errors:
            raise AssertionError(f"E3: a background stream failed: "
                                 f"{errors[0]!r}")
        expect_engine("E3", eng, bg + preqs, kernel_counts(), tally, L)
        length = eng._state.cache.length
        past = int((length > eng._state.cache.k.shape[2]).sum())
    finally:
        eng.shutdown()
    ttfts.sort()
    gaps.sort()
    period = gaps[len(gaps) // 2]
    out = dict(ttft_p50=ttfts[len(ttfts) // 2] * 1e3,
               ttft_p99=ttfts[-1] * 1e3, stall_ms=gaps[-1] * 1e3,
               stall_chunks=gaps[-1] / max(period, 1e-6))
    log(f"[E3] {probes} probes under {slots - 1} background streams: TTFT "
        f"p50 {out['ttft_p50']:.1f} ms, p99 {out['ttft_p99']:.1f} ms; "
        f"background stall max {out['stall_ms']:.1f} ms = "
        f"{out['stall_chunks']:.2f} x the median gap "
        f"({period * 1e3:.1f} ms); {stall_steps} decode steps; slots past "
        f"their cache at the end: {past}; {card}")
    return out


def engine_profile(params, cfg, dev, slots=12, chunk=8):
    """One decode chunk of `slots` rows (int8 KV, greedy), as the engine
    dispatches it, and one B=1 extend of 256 tokens under the profiler:
    kernels, wall and idle share."""
    import torch
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.serve.engine import _concat
    rng = np.random.default_rng(5)
    b = _concat([engine_request(cfg, i, 48, rng, dev) for i in range(slots)],
                dev)
    with torch.no_grad():
        st = medplib.stream_prefill(params, cfg, b, 4 * chunk, kv_quant=True)
        holder = [st]

        def one_chunk():
            holder[0], toks, _ = medplib.stream_decode_chunk(
                params, cfg, holder[0], chunk)
            toks.tolist()

        one_chunk()
        log(f"[engine profile] one decode chunk of {chunk} steps, "
            f"{slots} slots, int8 KV:")
        profile_step(one_chunk, always=True)
        del st, holder
        # E3's unit of admission work: one B=1 extend of 256 tokens
        e, am, sm, carry = medplib.stream_prefill_begin(
            params, cfg, engine_request(cfg, 50, 48, rng, dev), 4 * chunk,
            256, kv_quant=True)

        def one_extend():
            medplib.stream_prefill_chunk(params, cfg, carry, e, am, sm, 0,
                                         256).last_hidden.tolist()

        one_extend()
        log("[engine profile] one extend of 256 tokens, B=1, int8 KV:")
        profile_step(one_extend)


def engine_path(dev, results, card, params):
    """The serving engine on main_path's int4h flagship tree: E1, E2, E3
    (each with every launch count set to 0 just before it and read just
    after), then one profiled decode chunk."""
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    cfg = flagship_cfg(32, moe=True)
    out = {}
    for name, run in (
            ("E1", lambda: engine_e1_e2(params, cfg, dev, card, False)),
            ("E2", lambda: engine_e1_e2(params, cfg, dev, card, True)),
            ("E3", lambda: engine_e3(params, cfg, dev, card)),
            ("profile", lambda: engine_profile(params, cfg, dev))):
        t0 = time.time()
        out[name] = run()
        torch.cuda.empty_cache()
        log(f"[{name}] done in {time.time() - t0:.1f} s")
    return out


def small_engine_check(dev):
    """The tiny MoE serving model (int4h experts) through BatchedEngine on
    the CPU (plain versions) and on the card (kernels): 4 slots, 8
    requests (T_in=64: 79 spliced tokens, <SEG> in the prompt), group
    admission, prefill_chunk 256, so a group of 3-4 pads to 4 rows x 256 =
    1024 rows: the grouped matmul (K1). Tokens equal; masks from ground()
    within _tiny_card_vs_cpu's tolerance; the card launches K1 and K2 as
    counted. Then idle_slot_run on both: equal tokens, and a slot's
    length past its cache on the card."""
    from medplib_tpu_torch.serve.engine import BatchedEngine
    from medplib_tpu_torch.utils.convert import tree_from_numpy
    cfg = tiny_serving_cfg(512, 8)
    host = _tiny_moe_tree(cfg, 4)
    out = {}
    for where in ("cpu", dev):
        params = tree_from_numpy(host, where)
        rng = np.random.default_rng(0)
        batches = [engine_request(cfg, i, 64, rng, where, seg=True)
                   for i in range(8)]
        eng = BatchedEngine(cfg, params, slots=4, max_new_tokens=8, chunk=4,
                            group_admission=True, prefill_chunk=256)
        try:
            reset_counts()
            with engine_tally() as tally:
                reqs, toks, _ = engine_wave(eng, batches, timeout=300)
            counts = kernel_counts()
            masks = [r.ground()[0].cpu() for r in reqs]
        finally:
            eng.shutdown()
        if where == "cpu":
            expect_counts("small engine check, CPU", counts)
        else:
            expect_engine("small engine check, card", eng, reqs, counts,
                          tally, cfg.llm.num_layers)
        if tally.k1_extends() < 1:
            raise AssertionError("small engine check: no extend of >= 1024 "
                                 "rows")
        out[str(where)] = (toks, masks)
    (tc, mc), (tg, mg) = out["cpu"], out[str(dev)]
    import torch
    mrel = max(rel_err(g, c) for g, c in zip(mg, mc))
    log(f"[small engine check] 8 requests, card vs CPU: tokens equal "
        f"{tc == tg}, mask rel err max {mrel:.3e}")
    if tc != tg or mrel > 5e-2 or not all(bool(torch.isfinite(m).all())
                                          for m in mg):
        raise AssertionError("small engine check: the card disagrees with "
                             "the CPU")
    idle = [idle_slot_run(cfg, tree_from_numpy(host, w), w)
            for w in ("cpu", dev)]
    log(f"[small engine check] a retired slot decodes past its cache "
        f"(int8 KV; final lengths {idle[1][1]} of {idle[1][2]} positions "
        f"on the card): tokens equal to the CPU {idle[0][0] == idle[1][0]}")
    if idle[0][0] != idle[1][0] or max(idle[1][1]) <= idle[1][2]:
        raise AssertionError("small engine check: the idle-slot run "
                             "disagrees or no slot passed its cache")


def idle_slot_run(cfg, params, where):
    """2 slots, int8 KV, no EOS: a request runs its 8 steps and retires at
    the end of its cache while a later one decodes on, so the retired
    slot's length walks past the cache (its K/V writes are dropped, as in
    JAX). -> (tokens of both, final lengths, cache positions)."""
    from medplib_tpu_torch.serve.engine import BatchedEngine
    rng = np.random.default_rng(1)
    first, late = (engine_request(cfg, i, 64, rng, where) for i in (0, 1))
    eng = BatchedEngine(cfg, params, slots=2, max_new_tokens=8, chunk=4,
                        kv_quant=True, eos_id=-1)
    try:
        r0 = eng.submit(first, temperature=0.0)
        r0.chunks.get(timeout=300)          # admitted: its first token
        r1 = eng.submit(late, temperature=0.0)
        toks = [[t for c in drain(r, 300) for t in c] for r in (r0, r1)]
        cache = eng._state.cache
        return toks, cache.length.tolist(), cache.k.shape[2]
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# serving front end (serve/controller.py, worker.py, web.py over HTTP in
# front of the engine)
# ---------------------------------------------------------------------------

class StubTokenizer:
    """An offline tokenizer with the surface the worker uses (no tokenizer
    files are in the repository): one id per whitespace word from its
    crc32 (the same in every process), "<SEG>" -> the model's SEG id,
    "</s>" -> EOS; decode writes one word per id, so a text's words count
    its tokens."""

    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0
    model_max_length = 2048

    def __init__(self, seg_id: int, vocab: int):
        self.seg_id, self.span = seg_id, min(vocab, seg_id) - 3

    def __call__(self, text, add_special_tokens=True):
        import types
        import zlib
        ids = [1] if add_special_tokens else []
        for w in text.replace("</s>", " </s> ").split():
            ids.append(2 if w == "</s>" else self.seg_id if w == "<SEG>"
                       else 3 + zlib.crc32(w.encode()) % self.span)
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"t{int(i)}" for i in ids)


class CliTokenizer(StubTokenizer):
    """StubTokenizer with the vocabulary surgery the training CLI does:
    added tokens take ids from 400 up (<SEG>, added first, is 400); its
    length is 440."""

    unk_token = pad_token = "<unk>"

    def __init__(self):
        super().__init__(seg_id=400, vocab=400)
        self.extra = {}

    def add_tokens(self, toks, special_tokens=False):
        for t in toks:
            self.extra.setdefault(t, 400 + len(self.extra))
        return len(toks)

    def convert_tokens_to_ids(self, tok):
        return self.extra.get(tok, 3)

    def __len__(self):
        return 440


def write_donors(root, cfg):
    """Two donor checkpoint directories (pytorch_model.bin) for stage-4
    expert seeding: a tiny LLaMA each from a seeded generator; donor 0 also
    text_hidden_fcs and a SAM mask decoder, donor 1 a region adapter.
    -> "dir0,dir1"."""
    import torch
    from medplib_tpu_torch.models import llama, sam_med2d
    from medplib_tpu_torch.utils import hf_export
    paths = []
    h, o = cfg.llm.hidden_size, cfg.seg.out_dim
    for idx in range(2):
        gen = torch.Generator().manual_seed(11 + idx)
        sd = hf_export.llama_to_hf(llama.init_llama(
            gen, cfg.llm, torch.float32, cfg.vocab_size_padded, "cpu"),
            cfg.llm)
        if idx == 0:
            for name, shape in (("0.0", (h, h)), ("0.2", (o, h))):
                sd[f"model.text_hidden_fcs.{name}.weight"] = torch.randn(
                    shape, generator=gen)
                sd[f"model.text_hidden_fcs.{name}.bias"] = torch.randn(
                    shape[:1], generator=gen)
            sam = sam_med2d.init_sam(gen, cfg.sam, torch.float32, "cpu")
            sd.update({k: v for k, v in hf_export.sam_to_torch(
                sam, cfg.sam, prefix="model.visual_model.").items()
                if k.startswith("model.visual_model.mask_decoder")})
        else:
            sd["model.region_fea_adapter.weight"] = torch.randn(
                (h, cfg.projector.mm_hidden_size), generator=gen)
            sd["model.region_fea_adapter.bias"] = torch.randn(
                (h,), generator=gen)
        d = os.path.join(root, f"donor{idx}")
        os.makedirs(d)
        torch.save({k: v.contiguous() for k, v in sd.items()},
                   os.path.join(d, "pytorch_model.bin"))
        paths.append(d)
    return ",".join(paths)


def cli_check(dev):
    """The port's training CLI in this process on the card, at --tiny:
    stage 4 (--moe-enable) from a saved tree with the experts seeded from
    two donor directories, 4 images and masks written from a numpy seed,
    two steps through the prefetching loader (2 workers), a checkpoint and
    a validation pass; then --eval-only restores step 2 and validates to
    the same numbers. The stub tokenizer stands in for
    transformers.AutoTokenizer.from_pretrained (no tokenizer files are in
    the repository). The temporary directory is removed."""
    import io
    import shutil
    import tempfile

    import torch
    import transformers
    from PIL import Image
    from medplib_tpu_torch import config as C
    from medplib_tpu_torch.data import tokenize as tk
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.train import cli
    from medplib_tpu_torch.utils.checkpoint import save_params

    root = tempfile.mkdtemp(prefix="cli_check_")
    auto = transformers.AutoTokenizer
    real = vars(auto)["from_pretrained"]
    try:
        rng = np.random.default_rng(0)
        records = []
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 50, 3), np.uint8)).save(
                os.path.join(root, f"im{i}.jpg"))
            m = np.zeros((40, 50), np.uint8)
            m[8 + i:20, 10:30] = 255
            Image.fromarray(m).save(os.path.join(root, f"m{i}.png"))
            records.append({"image": f"im{i}.jpg", "conversations": [
                {"from": "human", "value": "<image>\nSegment the lesion."},
                {"from": "gpt",
                 "value": f"<mask>m{i}.png</mask> It is <SEG> ."}]})
        for name, recs in (("train", records), ("val", records[:3])):
            with open(os.path.join(root, f"{name}.json"), "w") as f:
                json.dump(recs, f)
        tok = CliTokenizer()
        tk.add_special_tokens(tok)
        cfg = C.tiny_cli_config(
            C.MoeConfig(enable=True, num_experts=2, top_k=1),
            tok.convert_tokens_to_ids("<SEG>"), len(tok))
        save_params(os.path.join(root, "stage3.pt"), medplib.init_medplib(
            torch.Generator().manual_seed(1), cfg, torch.float32, "cpu"))
        donors = write_donors(root, cfg)
        auto.from_pretrained = staticmethod(lambda *a, **k: CliTokenizer())
        args = ["--version", os.path.join(root, "stage3.pt"),
                "--tokenizer", "stub", "--tiny", "--moe-enable",
                "--expert-pretrained-path", donors,
                "--dataset-json", os.path.join(root, "train.json"),
                "--image-folder", root,
                "--val-data-path", os.path.join(root, "val.json"),
                "--exp-name", "stage4", "--log-base-dir",
                os.path.join(root, "runs"), "--epochs", "1",
                "--steps-per-epoch", "2", "--batch-size", "2",
                "--model-max-length", "96", "--warmup-steps", "1",
                "--save-steps", "2", "--log-steps", "1", "--precision",
                "fp32", "--workers", "2", "--device", str(dev)]
        reset_counts()
        t0 = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            final = cli.main(args)
            vres = cli.main(args + ["--eval-only"])
        dt = time.time() - t0
        text = out.getvalue()
        ckpt = os.listdir(os.path.join(root, "runs", "stage4", "ckpt_model"))
        val = [ln for ln in text.splitlines() if "val:" in ln]
        evl = [ln for ln in text.splitlines() if "eval_only @ step" in ln]
        log(f"[cli check] train/cli.py --tiny --moe-enable with donors on "
            f"{dev}: 2 steps + validation, then --eval-only, {dt:.1f} s; "
            f"final step {final}, checkpoints {ckpt}; {val[-1:]}; "
            f"{evl[-1:]}")
        expect_counts("cli check", kernel_counts())
        if final != 2 or ckpt != ["2"] or not val or not evl \
                or "step 2:" not in evl[-1] \
                or val[-1].split("val: ")[1] != evl[-1].split("step 2: ")[1] \
                or not all(np.isfinite(v) for v in vres.values()):
            raise AssertionError("the training CLI did not train, save, "
                                 "resume and validate as expected")
    finally:
        auto.from_pretrained = real
        shutil.rmtree(root, ignore_errors=True)
    return vres


def front_prompt(question: str) -> str:
    """A serving prompt: conv_templates["v1"] with <image> and the
    question, the assistant's turn open."""
    from medplib_tpu_torch.data.conversation import conv_templates
    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], "<image>\n" + question)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def final_chunk(worker, payload):
    """One request in-process -> its last NUL-delimited JSON chunk."""
    from medplib_tpu_torch.serve import protocol
    return list(protocol.stream_chunks(
        b"".join(worker.generate_stream(payload))))[-1]


def mask_of(chunk):
    from medplib_tpu_torch.serve import protocol
    if not int(chunk["height"]):
        return None
    return protocol.decode_sparse_mask(chunk["mask"], int(chunk["height"]),
                                       int(chunk["width"]))


def small_worker_check(dev, max_mask_share=0.01):
    """The tiny int4h MoE serving model with the region adapter behind one
    port worker on the CPU (plain versions) and one on the card (kernels),
    both batched (4 slots, chunks of 4, 8 new tokens): a greedy VQA
    request, a <SEG> prompt, a region request and a sampled request with
    a seed, each a 96 x 120 PNG. Texts equal; where either side returns a
    mask, the two sparse masks differ in at most max_mask_share of their
    pixels (last-bit differences of the mask logits flip pixels near the
    threshold); the card launches K2 once per layer per decode step, K1
    never (B=1 prompts of < 1024 rows), the CPU nothing."""
    from medplib_tpu_torch.serve import protocol
    from medplib_tpu_torch.serve import worker as wk
    from medplib_tpu_torch.utils.convert import tree_from_numpy
    cfg = tiny_serving_cfg(512, 8)
    cfg = dataclasses.replace(cfg, projector=dataclasses.replace(
        cfg.projector, region_adapter=True))
    host = _tiny_moe_tree(cfg, 4)
    tok = StubTokenizer(cfg.seg_token_idx, cfg.llm.vocab_size)
    img = np.random.default_rng(3).integers(0, 256, (96, 120, 3),
                                            dtype=np.uint8)
    region = np.zeros(img.shape[:2], np.uint8)
    region[20:70, 30:90] = 1
    b64 = protocol.encode_image_b64(img)
    base = {"images": [b64], "temperature": 0.0}
    payloads = {
        "vqa": dict(base, prompt=front_prompt("what does the scan show")),
        "seg": dict(base, prompt=front_prompt("segment the <SEG> lesion")),
        "region": dict(base, prompt=front_prompt(
            "what is in <region> </region> here"),
            region_masks=[protocol.encode_sparse_mask(region)[0]],
            region_hw=list(region.shape)),
        "sampled": dict(base, prompt=front_prompt("describe the scan"),
                        temperature=0.7, top_p=0.9, seed=7)}
    out = {}
    for where in ("cpu", dev):
        w = wk.ModelWorker(cfg, tree_from_numpy(host, where), tok,
                           max_seq_len=128, max_new_tokens=8,
                           stream_interval=4, batched_slots=4)
        try:
            reset_counts()
            with engine_tally() as tally:
                finals = {k: final_chunk(w, p) for k, p in payloads.items()}
            counts = kernel_counts()
        finally:
            w.close()
        bad = {k: f for k, f in finals.items()
               if f["error_code"] != 0 or not f["text"]}
        if bad:
            raise AssertionError(f"small worker check ({where}): {bad}")
        if where == "cpu":
            expect_counts("small worker check, CPU", counts)
        else:
            expect_counts(f"small worker check, card ({tally.steps} decode "
                          f"steps)", counts,
                          moe_ffn_decode_int4h=cfg.llm.num_layers
                          * tally.steps)
        out[str(where)] = finals
    cpu, card = out["cpu"], out[str(dev)]
    shares = {}
    for k in payloads:
        mc, mg = mask_of(cpu[k]), mask_of(card[k])
        if mc is not None or mg is not None:
            shares[k] = (1.0 if mc is None or mg is None
                         or mc.shape != mg.shape else float((mc != mg).mean()))
    same = {k: cpu[k]["text"] == card[k]["text"] for k in payloads}
    log(f"[small worker check] card vs CPU: texts equal {same}; mask pixel "
        f"share differing {shares} (limit {max_mask_share}); seg mask "
        f"{card['seg']['height']} x {card['seg']['width']}")
    if not all(same.values()) or "seg" not in shares or \
            max(shares.values()) > max_mask_share:
        raise AssertionError("small worker check: the card disagrees with "
                             "the CPU")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_thread(httpd):
    import threading
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post_json(url, payload, timeout=60.0) -> bytes:
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def http_stream(url, payload, timeout=600.0):
    """POST JSON and read the NUL-delimited response as it arrives ->
    (seconds to the first complete chunk at the client, the chunks)."""
    import urllib.request
    from medplib_tpu_torch.serve import protocol
    t0 = time.time()
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    parts, first = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        while True:
            part = r.read1(1 << 16)
            if not part:
                break
            if first is None and b"\0" in part:
                first = time.time() - t0
            parts.append(part)
    return first, list(protocol.stream_chunks(b"".join(parts)))


def paeth_png(img) -> bytes:
    """img as an RGB PNG whose rows are all Paeth-filtered, the filter
    browsers and Pillow pick for most rows of a photograph."""
    import struct
    import zlib
    from medplib_tpu_torch.serve import png
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) % 256).astype(np.uint8).reshape(x.shape[0], -1)
    raw = np.concatenate([np.full((x.shape[0], 1), 4, np.uint8), rows], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", x.shape[1], x.shape[0], 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def front_payloads(cfg, n=24, seg_at=5):
    """W1's requests: n distinct 512 x 640 uint8 images from a numpy seed
    as base64 PNG, a v1 prompt with <image> each; request seg_at asks
    for <SEG>. Greedy, 32 new tokens."""
    from medplib_tpu_torch.serve import protocol
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
        q = (f"segment the lesion <SEG> in scan {i}" if i == seg_at
             else f"what does scan {i} show")
        out.append({"prompt": front_prompt(q),
                    "images": [protocol.encode_image_b64(img)],
                    "temperature": 0.0, "max_new_tokens": 32})
    return out


def front_wave(url, payloads, conc=12):
    """Every payload to `url`, conc at a time -> (finals, TTFTs s, wall s);
    any failed request raises."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(conc) as ex:
        res = list(ex.map(lambda p: http_stream(url, p), payloads))
    wall = time.time() - t0
    finals = [chunks[-1] for _, chunks in res]
    bad = [f for f in finals if f["error_code"] != 0 or not f["text"]]
    if bad:
        raise AssertionError(f"front end: {len(bad)} requests failed: "
                             f"{bad[0]['text'][:200]}")
    return finals, [t for t, _ in res], wall


def host_profile(worker, payload, top=12):
    """cProfile of one request alone, in-process: on Python >= 3.12 it
    sees every thread, so the front end (PNG decode, preprocess,
    tokenize, collate, detokenize, mask post-process) and the engine's
    loop (prefill, decode chunks, grounding) together."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    final_chunk(worker, payload)
    prof.disable()
    wall = time.time() - t0
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    log(f"[W1 host profile] one request alone {wall:.3f} s; host functions "
        f"by own time:")
    for (f, line, name), (_, nc, tt, ct, _) in rows:
        log(f"[W1 host profile]   {tt * 1e3:9.1f} ms own {ct * 1e3:9.1f} ms "
            f"cum {nc:7d} x {os.path.basename(f)}:{line} {name}")


def worker_path(dev, card, params, e1_tok_s):
    """The serving front end on the int4h flagship tree of the main path.

    W1: the port's controller, one ModelWorker (12 slots, int8 KV, chunks
    of 8, 32 new tokens, prompts up to 512 tokens) registered with it and
    web.serve in front, all on loopback in threads. 24 requests
    (front_payloads), 12 at a time, to web /generate (which proxies the
    worker's /worker_generate_stream and answers once it has the whole
    stream); then the same 24 straight to the worker's stream, whose TTFT
    is its first streamed chunk. Gates: every final chunk error_code 0
    with text; K1 0 and K2 32 x the decode steps the engine dispatched;
    queue_length back to 0 and the controller listing the worker; the
    second wave's texts equal; the <SEG> request's mask 512 x 640. Then
    the host preprocessing per image and a cProfile of one request.
    W2: the sequential worker (batched_slots=0) on two of the payloads:
    seconds per request, K2 count, texts equal to W1's (reported)."""
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.data import preprocess as pp
    from medplib_tpu_torch.serve import controller as ctl
    from medplib_tpu_torch.serve import png, protocol, web
    from medplib_tpu_torch.serve import worker as wk

    cfg = flagship_cfg(32, moe=True)
    L = cfg.llm.num_layers
    tok = StubTokenizer(cfg.seg_token_idx, cfg.llm.vocab_size)
    payloads = front_payloads(cfg)
    kw = dict(kv_quant=True, stream_interval=8, max_new_tokens=32,
              max_seq_len=512)
    cport, wport, uport = _free_port(), _free_port(), _free_port()
    curl = f"http://127.0.0.1:{cport}"
    wurl = f"http://127.0.0.1:{wport}"
    uurl = f"http://127.0.0.1:{uport}"
    csrv = _serve_thread(ctl.serve("127.0.0.1", cport))
    servers, worker, out = [csrv], None, {}
    try:
        worker = wk.ModelWorker(cfg, params, tok, controller_url=curl,
                                worker_url=wurl, batched_slots=12, **kw)
        servers.append(_serve_thread(wk.serve(worker, "127.0.0.1", wport)))
        servers.append(_serve_thread(web.serve(curl, "medplib-tpu",
                                               "127.0.0.1", uport)))
        t0 = time.time()
        for p in payloads[:2]:                      # warm-up
            http_stream(uurl + "/generate", p)
        log(f"[W1] warm-up {time.time() - t0:.1f} s")
        waves = []
        for name, url in (("web /generate", uurl + "/generate"),
                          ("worker stream", wurl + "/worker_generate_stream")):
            reset_counts()
            with engine_tally() as tally:
                finals, ttfts, wall = front_wave(url, payloads)
            expect_counts(f"W1 via {name} ({tally.steps} decode steps, "
                          f"{tally.prefills} prefills, extends "
                          f"{tally.extends})", kernel_counts(),
                          moe_ffn_decode_int4h=L * tally.steps,
                          flash_fwd=L * tally.prefills)
            n_tok = sum(len(f["text"].split()) for f in finals)
            ttfts = sorted(ttfts)
            r = dict(tok_s=n_tok / wall, req_s=len(payloads) / wall,
                     ttft_p50=ttfts[len(ttfts) // 2] * 1e3,
                     ttft_p99=ttfts[-1] * 1e3, steps=tally.steps)
            log(f"[W1] {len(payloads)} requests via {name}, 12 at a time: "
                f"{n_tok} tokens in {wall:.3f} s -> {r['tok_s']:.3f} tok/s, "
                f"{r['req_s']:.3f} req/s; TTFT at the client p50 "
                f"{r['ttft_p50']:.1f} ms, p99 {r['ttft_p99']:.1f} ms; "
                f"{tally.steps} decode steps")
            waves.append((finals, r))
        status = json.loads(_post_json(wurl + "/worker_get_status", {}))
        models = json.loads(_post_json(curl + "/list_models", {}))["models"]
        listed = wurl in csrv.controller.workers
        log(f"[W1] worker status {status}; controller models {models}, "
            f"worker listed {listed}")
        if status["queue_length"] != 0 or models != ["medplib-tpu"] \
                or not listed:
            raise AssertionError("W1: queue not drained or worker not "
                                 "registered")
        texts = [[f["text"] for f in finals] for finals, _ in waves]
        if texts[0] != texts[1]:
            raise AssertionError("W1: the second wave gave other texts")
        seg = mask_of(waves[0][0][5])
        if seg is None or seg.shape != (512, 640):
            raise AssertionError("W1: the <SEG> request's mask is not "
                                 "512 x 640")
        log(f"[W1] second wave texts equal; <SEG> request mask 512 x 640, "
            f"{int(seg.sum())} pixels set")
        t0 = time.time()
        for p in payloads:
            image = protocol.decode_image_b64(p["images"][0])
            pp.preprocess_sam(image, cfg.sam.image_size)
            pp.preprocess_clip(image, cfg.vision.image_size)
        pre_ms = (time.time() - t0) * 1e3 / len(payloads)
        img = protocol.decode_image_b64(payloads[0]["images"][0])
        paeth = paeth_png(img)
        if not np.array_equal(png.decode_rgb(paeth), img):
            raise AssertionError("W1: a Paeth-filtered PNG decodes wrong")
        raw = base64.b64decode(payloads[0]["images"][0])
        png_ms = []
        for blob in (raw, paeth):
            t0 = time.time()
            for _ in range(5):
                png.decode_rgb(blob)
            png_ms.append((time.time() - t0) * 1e3 / 5)
        log(f"[W1] PNG decode of one 512 x 640 image on this host: "
            f"{png_ms[0]:.1f} ms with None rows (the port's encoder), "
            f"{png_ms[1]:.1f} ms with Paeth rows")
        host_profile(worker, payloads[1])
        out = dict(web=waves[0][1], stream=waves[1][1], pre_ms=pre_ms,
                   png_ms=png_ms, texts=texts[0])
        log(f"[W1] host preprocessing (PNG decode + SAM + CLIP) "
            f"{pre_ms:.1f} ms per 512 x 640 image; W1 {out['web']['tok_s']:.3f}"
            f" tok/s via web, {out['stream']['tok_s']:.3f} straight to the "
            f"worker, E1 (engine alone, same run) {e1_tok_s:.3f} tok/s; "
            f"{card}")
    finally:
        for s in servers[::-1]:
            s.shutdown()
            s.server_close()
        csrv.controller.shutdown()
        if worker is not None:
            worker.close()
    torch.cuda.empty_cache()
    seq = wk.ModelWorker(cfg, params, tok, batched_slots=0, **kw)
    secs, same = [], 0
    for i in (0, 5):
        reset_counts()
        with engine_tally() as tally:
            t0 = time.time()
            f = final_chunk(seq, payloads[i])
            secs.append(time.time() - t0)
        if f["error_code"] != 0 or not f["text"]:
            raise AssertionError(f"W2: request {i} failed: {f['text']}")
        expect_counts(f"W2 request {i} ({tally.steps} decode steps)",
                      kernel_counts(), moe_ffn_decode_int4h=L * tally.steps,
                      flash_fwd=L * tally.prefills)
        same += f["text"] == out["texts"][i]
    out["w2_s"] = sum(secs) / len(secs)
    log(f"[W2] sequential worker: {', '.join(f'{s:.3f}' for s in secs)} s "
        f"per request; texts equal to W1's {same}/2 (reported: decode at "
        f"M = 1 against M <= 12); {card}")
    return out


# ---------------------------------------------------------------------------
# evaluation, gate analysis, retrieval, SAM predictor / AMG (eval/, rag/,
# models/sam_predictor.py, models/amg.py) on the int4h flagship tree
# ---------------------------------------------------------------------------

def write_eval_set(root, n_img=32, n_eval=24, hw=(384, 512)):
    """n_img seeded 512 x 384 RGB PNGs (a coloured background, five
    rectangles, noise) each with an elliptic binary mask PNG; test.json:
    the first n_eval as LazySupervisedDataset records (a seg question
    ending in " :", the answer "It is <SEG>" with the mask; open and
    closed answer types); cands.json: every (image, mask) pair;
    queries.json: every fourth image. -> file names of the images."""
    from PIL import Image
    rng = np.random.default_rng(0)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    names = []
    for i in range(n_img):
        img = np.empty((h, w, 3), np.float32)
        img[:] = rng.uniform(0, 255, 3)
        for _ in range(5):
            y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
            img[y0:y0 + rng.integers(20, h // 2),
                x0:x0 + rng.integers(20, w // 2)] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 12, img.shape)
        name = f"ct_{i:02d}.png"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, name))
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.1, 0.3) * w
        m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1)
        Image.fromarray(m.astype(np.uint8) * 255).save(
            os.path.join(root, f"mask_{i:02d}.png"))
        names.append(name)
    test = [{"image": names[i], "answer_type": ("open", "closed")[i % 2],
             "conversations": [
                 {"from": "human", "value": f"<image>\nPlease segment the "
                  f"lesion in scan {i} :"},
                 {"from": "gpt", "value": f"It is <SEG> <mask>mask_{i:02d}"
                  f".png</mask>"}]} for i in range(n_eval)]
    cands = [{"image": n, "mask": f"mask_{i:02d}.png"}
             for i, n in enumerate(names)]
    queries = [{"image": names[i]} for i in range(0, n_img, 4)]
    for fname, recs in (("test.json", test), ("cands.json", cands),
                        ("queries.json", queries)):
        with open(os.path.join(root, fname), "w") as f:
            json.dump(recs, f)
    return names


def sam_card_vs_cpu(dev, sam_cfg, sam_cpu, img, iou_tol=1e-3,
                    logit_rel=1e-3, pix_share=1e-3):
    """SamPredictor.predict on the card against the same predictor on the
    CPU, one f32 tree (TF32 off): points (multimask), a box, points + box,
    then points with the previous low-res logits as mask_input. Holds the
    IoU predictions to iou_tol (absolute), the low-res logits to
    logit_rel (norm-relative) and the binarized masks to pix_share of
    their pixels. -> (the card predictor, the worst of each)."""
    from medplib_tpu_torch.models.sam_predictor import SamPredictor
    card, host = SamPredictor(_to(sam_cpu, dev), sam_cfg), \
        SamPredictor(sam_cpu, sam_cfg)
    for p in (card, host):
        p.set_image(img)
    h, w = img.shape[:2]
    pts = np.array([[w * 0.5, h * 0.5], [w * 0.25, h * 0.7]])
    calls = [dict(point_coords=pts, point_labels=np.array([1, 0]),
                  multimask_output=True),
             dict(box=np.array([w * 0.1, h * 0.2, w * 0.8, h * 0.9]),
                  multimask_output=False),
             dict(point_coords=pts[:1], point_labels=np.array([1]),
                  box=np.array([4, 6, w - 8, h - 10]),
                  multimask_output=True)]
    worst = dict(iou=0.0, logits=0.0, pixels=0.0)
    low = None
    for kw in calls + [None]:
        if kw is None:      # the mask prompt: the last call's logits
            kw = dict(point_coords=pts[:1], point_labels=np.array([1]),
                      mask_input=low[0], multimask_output=False)
        (mc, ic, lc), (mh, ih, lh) = card.predict(**kw), host.predict(**kw)
        low = lh
        worst["iou"] = max(worst["iou"], float(np.abs(ic - ih).max()))
        worst["logits"] = max(worst["logits"], float(
            np.linalg.norm(lc - lh) / max(np.linalg.norm(lh), 1e-30)))
        worst["pixels"] = max(worst["pixels"], float((mc != mh).mean()))
        if mc.shape != mh.shape or mc.shape[1:] != (h, w):
            raise AssertionError("SAM predict: mask shapes differ")
    log(f"[sam] predict card vs CPU ({len(calls) + 1} calls, {h} x {w}): "
        f"IoU max |diff| {worst['iou']:.2e} (tol {iou_tol}), low-res "
        f"logits rel {worst['logits']:.2e} (tol {logit_rel}), mask pixels "
        f"differing {worst['pixels']:.2e} (tol {pix_share})")
    if (worst["iou"] > iou_tol or worst["logits"] > logit_rel
            or worst["pixels"] > pix_share):
        raise AssertionError("SAM predict: the card disagrees with the CPU")
    return card, worst


def eval_path(dev, card, params, cfg=None, n_img=32, n_eval=24, B=16,
              NEW=10):
    """Evaluation, gate analysis, retrieval and the SAM predictor on the
    int4h flagship tree of the main path, from seeded PNGs written to a
    temp directory (write_eval_set) and the stub tokenizer.

    (a) Evaluator.run(mode="seg"), then "vqa", batch 16, 10 new tokens:
    24 samples, so the second batch is padded. Act quant stays off, as
    the JAX Evaluator leaves it: K1 on bf16 x, 3·L launches per generate
    call, K2 L·10. Every record is held to a direct generate call on the
    same collated batch (equal tokens and masks, so equal text, IoU and
    Dice). (b) capture_router_logits on one B=16 batch (K1 3·L): finite
    logits, expert_load fractions summing to 1 per layer, the per-layer
    load logged. (c) ImageRagEncoder on the CLIP subtree: build_index
    over the n_img images, augment every fourth as a query (top 2): each
    retrieves itself first at cosine >= 0.999. (d) SamPredictor on the
    SAM subtree in f32: predict card vs CPU (sam_card_vs_cpu), then
    generate_masks(points_per_side=16, crop_n_layers=1,
    min_mask_region_area=16, coco_rle) with no score filter (the random
    IoU head's scores mean nothing): each record's RLE decodes to its
    area. -> the numbers of the [result] line."""
    import tempfile

    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.data import preprocess as pp
    from medplib_tpu_torch.data.dataset import (CollatorConfig, DataConfig,
                                                LazySupervisedDataset,
                                                collate, to_model_batch)
    from medplib_tpu_torch.eval import gate_analysis as ga
    from medplib_tpu_torch.eval import infer, seg_metrics
    from medplib_tpu_torch.models import amg, medplib
    from medplib_tpu_torch.models import sam_predictor as sp
    from medplib_tpu_torch.rag import image_rag
    from medplib_tpu_torch.utils.hf_weights import cast_tree
    from medplib_tpu_torch.utils.quantize import act_quant_enabled

    cfg = cfg or flagship_cfg(32, moe=True)
    L = cfg.llm.num_layers
    tok = StubTokenizer(cfg.seg_token_idx, cfg.llm.vocab_size)
    colon = tok(":", add_special_tokens=False).input_ids[0]
    t_phase = time.time()
    out = {}
    with tempfile.TemporaryDirectory(prefix="eval_path_") as root:
        names = write_eval_set(root, n_img, n_eval)
        ds = LazySupervisedDataset(DataConfig(
            data_path=os.path.join(root, "test.json"), image_folder=root,
            conv_template="v1", augment_regions=False,
            sam_image_size=cfg.sam.image_size,
            clip_image_size=cfg.vision.image_size,
            clip_patch=cfg.vision.patch_size), tok, train=False)
        cc = CollatorConfig(max_seq_len=48,
                            image_tokens=cfg.vision.num_patches,
                            sam_image_size=cfg.sam.image_size,
                            clip_image_size=cfg.vision.image_size)
        # (a) evaluation
        log(f"[eval] K1 mode: {'W4A8' if act_quant_enabled() else 'bf16 x'}"
            f" (act quant {'on' if act_quant_enabled() else 'off'}, as the "
            f"JAX Evaluator leaves it)")
        for mode in ("seg", "vqa"):
            path = os.path.join(root, f"{mode}.jsonl")
            ev = infer.Evaluator(cfg, params, tok, infer.EvalConfig(
                batch_size=B, max_new_tokens=NEW, colon_token_id=colon,
                output_path=path), cc, device=dev)
            calls, orig = [], medplib.generate

            def counted(*a, **k):
                reset_counts()
                r = orig(*a, **k)
                torch.cuda.synchronize()
                calls.append((a[2], r, kernel_counts()))
                return r

            medplib.generate = counted
            try:
                t0 = time.time()
                metrics = ev.run(ds, mode)
                wall = time.time() - t0
            finally:
                medplib.generate = orig
            rows = [json.loads(line) for line in open(path)]
            if len(rows) != n_eval or len(calls) != -(-n_eval // B):
                raise AssertionError(f"eval {mode}: {len(rows)} records in "
                                     f"{len(calls)} generate calls")
            for k, (batch, res, counts) in enumerate(calls):
                expect_counts(f"eval {mode} call {k}", counts,
                              gmm_int4h=3 * L, moe_ffn_decode_int4h=L * NEW,
                              flash_fwd=L)
                direct = medplib.generate(params, cfg, batch,
                                          max_new_tokens=NEW,
                                          eos_id=tok.eos_token_id)
                if not (torch.equal(direct.output_ids, res.output_ids)
                        and torch.equal(direct.pred_masks, res.pred_masks)):
                    raise AssertionError(f"eval {mode} call {k}: the direct "
                                         f"generate differs")
                ids = direct.output_ids.cpu().numpy()
                n = direct.num_generated.cpu().numpy()
                masks = direct.pred_masks.float().cpu().numpy()
                for j, rec in enumerate(rows[k * B:(k + 1) * B]):
                    if rec["text"] != ev._decode(ids[j], int(n[j])):
                        raise AssertionError(f"eval {mode}: record "
                                             f"{rec['question_id']} text")
                    if mode == "seg":
                        s = ds[rec["question_id"]]
                        gt = s["gt_masks_original"][0]
                        pred = pp.unpad_and_resize_mask(
                            masks[j, 0], s["resize_hw"], gt.shape)
                        if (rec["iou"], rec["dice"]) != \
                                seg_metrics.sample_iou_dice(pred, gt):
                            raise AssertionError(
                                f"eval seg: record {rec['question_id']} "
                                f"IoU / Dice")
            out[f"{mode}_s"] = wall / n_eval
            log(f"[eval] {mode}: {n_eval} samples in {wall:.3f} s -> "
                f"{out[f'{mode}_s']:.4f} s/sample ({len(calls)} generate "
                f"calls of B={B}, the last padded); records equal to direct "
                f"generate calls; metrics "
                f"{json.dumps(metrics, default=str)}; {card}")
        # (b) gate analysis
        arrays, _ = collate([ds[i] for i in range(B)], cc)
        batch = to_model_batch(arrays, dev)
        reset_counts()
        t0 = time.time()
        cap = ga.capture_router_logits(params, cfg, batch)
        torch.cuda.synchronize()
        t_cap = time.time() - t0
        expect_counts("gate capture", kernel_counts(), gmm_int4h=3 * L,
                      flash_fwd=L)
        logits = cap["router_logits"]
        if logits.shape[:2] != (L, B) or not np.isfinite(logits).all():
            raise AssertionError("gate capture: logits not finite or of "
                                 "the wrong shape")
        load = ga.expert_load(cap)
        for kind in ("text", "image"):
            if not np.allclose(load[kind].sum(-1), 1.0):
                raise AssertionError(f"expert_load: {kind} fractions do "
                                     f"not sum to 1")
            log(f"[gate] {kind} tokens, expert 0's share per layer: " +
                " ".join(f"{v:.3f}" for v in load[kind][:, 0]))
        major = {k: float(np.maximum(v[:, 0], v[:, 1]).mean())
                 for k, v in load.items()}
        out["gate"] = major
        log(f"[gate] B={B} x {logits.shape[2]} tokens in {t_cap:.3f} s; "
            f"mean share of the busier expert: text {major['text']:.3f}, "
            f"image {major['image']:.3f} (random routers); {card}")
        # (c) retrieval
        enc = image_rag.ImageRagEncoder(params["clip"], cfg.vision,
                                        batch_size=B)
        idx_dir = os.path.join(root, "index")
        t0 = time.time()
        info = image_rag.build_index(os.path.join(root, "cands.json"), root,
                                     idx_dir, enc)
        torch.cuda.synchronize()
        t_idx = time.time() - t0
        aug = os.path.join(root, "aug.json")
        image_rag.augment(os.path.join(root, "queries.json"), idx_dir, aug,
                          enc, top_k=2, image_folder=root)
        recs = json.load(open(aug))
        qi = list(range(0, n_img, 4))
        sims = enc.encode_paths([os.path.join(root, names[i]) for i in qi]) \
            @ np.load(os.path.join(idx_dir, "embeddings.npy")).T
        self_cos = sims[np.arange(len(qi)), qi]
        others = sims.copy()
        others[np.arange(len(qi)), qi] = -1
        if info["count"] != n_img or any(
                r["icl_examples"][0]["image"] != os.path.join(root, names[i])
                or len(r["icl_examples"]) != 2 for r, i in zip(recs, qi)) \
                or self_cos.min() < 0.999:
            raise AssertionError("retrieval: a query did not retrieve "
                                 "itself first at cosine >= 0.999")
        out["rag_img_s"] = n_img / t_idx
        log(f"[rag] index of {n_img} images ({info['dim']}-d) in "
            f"{t_idx:.3f} s -> {out['rag_img_s']:.2f} images/s (PNG decode "
            f"+ CLIP preprocess + bf16 CLIP ViT-L); {len(qi)} queries "
            f"retrieve themselves first, cosine min {self_cos.min():.6f}, "
            f"best other {others.max():.6f}; {card}")
        # (d) SAM predictor and automatic mask generation
        img = pp.load_image_rgb(os.path.join(root, names[0]))
        sam_cpu = cast_tree(_to(params["sam"], "cpu"), torch.float32)
        pred, _ = sam_card_vs_cpu(dev, cfg.sam, sam_cpu, img)
        t0 = time.time()
        masks = sp.generate_masks(
            pred, img, points_per_side=16, pred_iou_thresh=-1e9,
            stability_score_thresh=0.0, crop_n_layers=1,
            min_mask_region_area=16, output_mode="coco_rle")
        t_amg = time.time() - t0
        for r in masks:
            m = amg.rle_to_mask(amg.coco_decode_rle(r["segmentation"]))
            if m.shape != img.shape[:2] or int(m.sum()) != r["area"]:
                raise AssertionError("AMG: an RLE does not decode to its "
                                     "area")
        if not masks:
            raise AssertionError("AMG: no masks")
        out["amg_masks_s"] = len(masks) / t_amg
        log(f"[amg] generate_masks 16 x 16 points, 1 crop layer (5 crops), "
            f"min region 16, coco_rle: {len(masks)} masks in {t_amg:.3f} s"
            f" -> {out['amg_masks_s']:.2f} masks/s; every RLE decodes to "
            f"its area; {card}")
        del pred, sam_cpu
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    log(f"[eval, gate, rag, sam] done in {out['phase_s']:.1f} s")
    return out


def init_bf16_flagship(cfg, gen, dev):
    """Random bf16 MedPLIB-7b-2e (with cfg's projector extras) without the
    dead dense MLP stack: the dense skeleton, stripped, then the experts
    written into one [L, E, ...] stack a layer at a time (no whole-stack
    float32 temporaries)."""
    import torch
    from medplib_tpu_torch.config import MoeConfig
    from medplib_tpu_torch.models import medplib, moe_llama
    from medplib_tpu_torch.ops.initializers import normal

    bf = torch.bfloat16
    params = medplib.init_medplib(
        gen, dataclasses.replace(cfg, moe=MoeConfig()), bf, dev)
    params["llm"] = moe_llama.strip_dense_mlp(params["llm"], cfg.llm,
                                              cfg.moe)
    L, E = cfg.llm.num_layers, cfg.moe.num_experts
    H, M = cfg.llm.hidden_size, cfg.llm.intermediate_size
    experts = {n: {"kernel": torch.empty((L, E) + shape, dtype=bf,
                                         device=dev)}
               for n, shape in (("gate_proj", (H, M)), ("up_proj", (H, M)),
                                ("down_proj", (M, H)))}
    for i in range(L):
        one = moe_llama.init_experts(gen, cfg.llm, cfg.moe, bf, dev)
        for n in experts:
            experts[n]["kernel"][i] = one[n]["kernel"]
    params["llm"]["layers"]["moe"] = {
        "router": {"kernel": normal(gen, (L, H, E), bf, dev, H ** -0.5)},
        "experts": experts}
    return params


def region_path(dev, results, card):
    """Released checkpoint -> sampled region VQA on MedPLIB-7b-2e at full
    width (32 layers x 2 experts), random bf16 weights from a seed:

    1. the bf16 tree with the 576 -> 256 compressor and the region adapter
       (~11.4 B parameters) -> a merged-HF state dict in the released
       layout (utils/hf_export.medplib_to_hf, views of the tree) ->
       utils/export.load_reference_checkpoint; the loaded tree must equal
       the source leaf for leaf (torch.equal; CLIP and the compressor,
       which the merged export does not carry, keep their initialized
       leaves, the dense-MLP placeholder is stripped as serving does);
       then the source is freed;
    2. benchmarks/run_all.py config 3 as written (bench_region): B=2,
       T_in=48, a region marker at 4 with a g/3 x g/3 mask, the
       compressor (303 spliced tokens a row), generate(rp_flag=True,
       ground=False), 16 new tokens, ms/sample, one profiled call.
       Launches: none (606
       prefill tokens take the capacity-sort path, bf16 experts have no
       fused decode, 303-token rows stay below the flash gate);
    3. quantize_flagship_moe(expert_bits=4) of the loaded tree (int4h
       experts padded to M=11264, int8 attention / lm_head / projector);
    4. region VQA in the serving form: B=16, T_in=48 with <SEG> (623
       spliced tokens, no compressor), dynamic_act_quant, 10 new tokens,
       grounding on; rows 0-7 sampled (t=0.7, top_p=0.9, one seed per
       row), rows 8-15 greedy (t=0): K1 = 96, K2 = 320; one profiled
       call; a repeat gives the same tokens (serve_batch), other seeds
       change a sampled row and no greedy row; then one B=1 request (sort
       prefill: K2 = 320, no K1)."""
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib, moe_llama
    from medplib_tpu_torch.utils import tree as tree_util
    from medplib_tpu_torch.utils.export import load_reference_checkpoint
    from medplib_tpu_torch.utils.hf_export import medplib_to_hf
    from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                                  quantize_flagship_moe)

    base = flagship_cfg(32, moe=True)
    cfg = dataclasses.replace(base, projector=dataclasses.replace(
        base.projector, token_compress=True, region_adapter=True))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    src = init_bf16_flagship(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    torch.cuda.synchronize()
    n_param = sum(x.numel() for x in tree_util.leaves(src))
    log(f"[region] bf16 MedPLIB-7b-2e + compressor + region adapter: "
        f"{n_param / 1e9:.3f} B parameters, built in {time.time() - t0:.1f}"
        f" s; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    t0 = time.time()
    sd = medplib_to_hf(src, cfg)
    n_keys = len(sd)
    _, params = load_reference_checkpoint(state_dict=sd, cfg=cfg,
                                          device=dev)
    del sd
    params["llm"] = moe_llama.strip_dense_mlp(params["llm"], cfg.llm,
                                              cfg.moe)
    params["clip"] = src["clip"]
    params["mm_token_compressor"] = src["mm_token_compressor"]
    torch.cuda.synchronize()
    t_load = time.time() - t0
    got, want = (tree_util.leaves_with_paths(params),
                 tree_util.leaves_with_paths(src))
    same_paths = [p for p, _ in got] == [p for p, _ in want]
    unequal = [p for (p, a), (_, w) in zip(got, want)
               if a.dtype != w.dtype or not torch.equal(a, w)]
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[region] released-layout state dict ({n_keys} keys) loaded in "
        f"{t_load:.3f} s: {len(got)} leaves, paths equal "
        f"{same_paths}, leaves not torch.equal {len(unequal)}; peak "
        f"allocated {load_peak:.2f} GiB")
    if not same_paths or unequal:
        raise AssertionError(f"the loader round trip changed the tree: "
                             f"{unequal[:4]}")
    del src, got, want
    torch.cuda.empty_cache()

    # 2. run_all.py config 3
    B3, T3, NEW3 = 2, 48, 16
    b3 = region_batch(cfg, B3, T3, np.random.default_rng(0), dev, seg=False)
    spliced = T3 + cfg.projector.compress_tokens - 1
    log(f"[config 3] B={B3}, T_in={T3}, region marker at 4, compressor -> "
        f"{spliced} spliced tokens a row, ground=False, {NEW3} new tokens")

    def run3():
        r = medplib.generate(params, cfg, b3, max_new_tokens=NEW3,
                             rp_flag=True, ground=False)
        torch.cuda.synchronize()
        return r

    per_s3, peak3, _ = serve_batch("config 3", run3, cfg, B3, NEW3, card,
                                   flash_fwd=cfg.llm.num_layers)
    cfg3_ms = 1e3 / per_s3
    profile_step(run3)

    # 3. the serving quantization
    t0 = time.time()
    params = quantize_flagship_moe(params, expert_bits=4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[region] quantize_flagship_moe(expert_bits=4) in "
        f"{time.time() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # 4. sampled region VQA, B=16, and one request
    scfg = dataclasses.replace(cfg, projector=dataclasses.replace(
        cfg.projector, token_compress=False))
    B, T, NEW = 16, 48, 10
    L = scfg.llm.num_layers
    batch = region_batch(scfg, B, T, np.random.default_rng(0), dev)
    single = region_batch(scfg, 1, T, np.random.default_rng(1), dev)
    temps = torch.tensor([0.7] * (B // 2) + [0.0] * (B // 2), device=dev)
    seeds = torch.arange(1000, 1000 + B, device=dev)

    def run(b, t, rng):
        with dynamic_act_quant(True):
            r = medplib.generate(params, scfg, b, max_new_tokens=NEW,
                                 rp_flag=True, do_sample=True,
                                 temperature=t, top_p=0.9, rng=rng)
        torch.cuda.synchronize()
        return r

    masks_per_s, peak, counts = serve_batch(
        "region", lambda: run(batch, temps, seeds), scfg, B, NEW, card,
        gmm_int4h=3 * L, moe_ffn_decode_int4h=L * NEW, flash_fwd=L)
    profile_step(lambda: run(batch, temps, seeds))
    first = run(batch, temps, seeds).output_ids
    other = run(batch, temps, seeds + B).output_ids
    h = B // 2
    moved = int((other[:h] != first[:h]).any(-1).sum())
    log(f"[region] other seeds: {moved} of {h} sampled rows changed, greedy "
        f"rows equal {torch.equal(other[h:], first[h:])}")
    if moved == 0 or not torch.equal(other[h:], first[h:]):
        raise AssertionError("region: the per-row seeds do not steer the "
                             "sampled rows alone")
    serve_single("region", lambda: run(single, temps[:1], seeds[:1]), scfg,
                 NEW, moe_ffn_decode_int4h=L * NEW, flash_fwd=L)
    return dict(cfg3_ms=cfg3_ms, cfg3_peak=peak3, load_peak=load_peak,
                masks_per_s=masks_per_s, peak=peak)


def make_icl_batch(cfg, b, t, rng, dev):
    """benchmarks/run_all.py bench_icl's batch: random ids with BOS, three
    image sentinels (query + 2 in-context examples) at 2, 4, 6 and <SEG>
    at T-3; three CLIP images per row, N(0,1); SAM pixels 0..255."""
    import torch
    from medplib_tpu_torch.config import IMAGE_TOKEN_INDEX
    from medplib_tpu_torch.models.medplib import Batch
    n_img = 3
    ids = rng.integers(3, cfg.llm.vocab_size, size=(b, t))
    ids[:, 0] = 1
    for k in range(n_img):
        ids[:, 2 + 2 * k] = IMAGE_TOKEN_INDEX
    ids[:, t - 3] = cfg.seg_token_idx
    vs, ss = cfg.vision.image_size, cfg.sam.image_size
    clip_px = rng.normal(size=(b, n_img, vs, vs, 3)).astype(np.float32)
    sam_px = rng.uniform(0, 255, size=(b, ss, ss, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, 1, ss, ss)) > 0.5).astype(np.float32)
    td = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return Batch.make(
        input_ids=td(ids), input_mask=td(np.ones((b, t), np.int32)),
        labels=td(ids), images_clip=td(clip_px), images_sam=td(sam_px),
        image_token_lengths=td(np.full((b, n_img), cfg.vision.num_patches,
                                       np.int32)),
        gt_masks=td(gt), mask_valid=td(np.ones((b, 1), bool)),
        sam_frame=ss)


def int8_path(dev, results, card):
    """Two serving configurations over one int8-expert MedPLIB-7b-2e tree
    (_init_flagship_moe_quantized's default expert_bits=8, built one
    expert layer at a time; int8 attention / lm_head / projector):

    - the int8-expert flagship (bench.py with BENCH_MOE_EXPERT_BITS=8):
      B=8 grounding requests, T_in=48 (623 spliced tokens), 10 new tokens,
      int8 KV cache, W8A8 prefill through K3 (3 per layer), decode on the
      capacity-sort path; one profiled call; then a single request (sort
      prefill at 623 tokens: no K3);
    - ICL config 5 (benchmarks/run_all.py bench_icl): icl_enable, B=4,
      T_in=64 with three images per row (1789 spliced tokens), 10 new
      tokens, no activation quant, bf16 KV cache: K3 in int8-w mode and
      flash attention K4 at prefill; one profiled call."""
    import dataclasses as dc

    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant

    cfg = flagship_cfg(32, moe=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    params = init_flagship(cfg, gen, dev, expert_bits=8)
    torch.cuda.synchronize()
    log(f"[int8] int8-expert flagship initialized + quantized in "
        f"{time.time() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    L, NEW = cfg.llm.num_layers, 10
    B, T = 8, 48
    batch = make_batch(cfg, B, T, np.random.default_rng(0), dev)
    single = make_batch(cfg, 1, T, np.random.default_rng(1), dev)

    def run(c, b, actq, kv_quant):
        with dynamic_act_quant(actq):
            r = medplib.generate(params, c, b, max_new_tokens=NEW,
                                 kv_quant=kv_quant)
        torch.cuda.synchronize()
        return r

    masks_per_s, peak, counts = serve_batch(
        "int8", lambda: run(cfg, batch, True, True), cfg, B, NEW, card,
        gmm=3 * L, flash_fwd=L)
    results["gmm"]["launches"] = counts["gmm"]
    profile_step(lambda: run(cfg, batch, True, True))
    serve_single("int8", lambda: run(cfg, single, True, True), cfg, NEW,
                 flash_fwd=L)

    icfg = dc.replace(cfg, icl_enable=True)
    IB, IT = 4, 64
    ibatch = make_icl_batch(icfg, IB, IT, np.random.default_rng(0), dev)
    spliced = IT + 3 * (cfg.vision.num_patches - 1)
    log(f"[icl] B={IB}, T_in={IT}, 3 images per row -> {spliced} spliced "
        f"tokens per row")
    icl_per_s, icl_peak, _ = serve_batch(
        "icl", lambda: run(icfg, ibatch, False, False), icfg, IB, NEW, card,
        gmm=3 * L, flash_fwd=L)
    profile_step(lambda: run(icfg, ibatch, False, False))
    return dict(masks_per_s=masks_per_s, peak=peak,
                icl_ms_per_sample=1e3 / icl_per_s, icl_peak=icl_peak)


def packed_path(dev, results, card):
    """Packed dense serving (bench.py with BENCH_MOE=0 BENCH_PACK=1): the
    dense LLaMA-style MedPLIB-7B at full width, bf16 init from a seeded
    generator on the card, llama.pack_inference (fused qkv_proj /
    gateup_proj), then quantize_tree:

    - int8 (BENCH_QUANT=int8): B=16, T_in=48 (623 spliced tokens), 10 new
      tokens, W8A8 prefill: the packed kernels on K7 (weight-only, as in
      JAX: 2 per layer per LLM pass, 2 x 32 x 11 = 704), o_proj /
      down_proj on W8A8;
    - int4h (BENCH_QUANT=int4, G = 8): B=12, no activation quant: the
      packed kernels on K9 (704), the other linears on the grouped int4h
      products;

    each with one profiled call and then a single request.

    Each tree is freed before the next is built."""
    import torch
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import llama, medplib
    from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                                  quantize_tree)
    cfg = flagship_cfg(32, moe=False)
    L, T, NEW = cfg.llm.num_layers, 48, 10
    want = 2 * L * (1 + NEW)
    out = {}
    for bits, B, actq, kernel in ((8, 16, True, "int8_matmul"),
                                  (4, 12, False, "int4h_matmul")):
        name = f"packed int{bits}"
        t0 = time.time()
        params = medplib.init_medplib(
            torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16,
            dev)
        params["llm"] = llama.pack_inference(params["llm"])
        params = quantize_tree(params, bits=bits)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[{name}] dense 7B packed + quantized in {time.time() - t0:.1f}"
            f" s; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        batch = make_batch(cfg, B, T, np.random.default_rng(0), dev)
        single = make_batch(cfg, 1, T, np.random.default_rng(1), dev)

        def run(b):
            with dynamic_act_quant(actq):
                r = medplib.generate(params, cfg, b, max_new_tokens=NEW)
            torch.cuda.synchronize()
            return r

        per_s, peak, counts = serve_batch(name, lambda: run(batch), cfg, B,
                                          NEW, card, flash_fwd=L,
                                          **{kernel: want})
        results[kernel]["launches"] = counts[kernel]
        profile_step(lambda: run(batch))
        serve_single(name, lambda: run(single), cfg, NEW, flash_fwd=L,
                     **{kernel: want})
        out[bits] = (per_s, peak)
        del params, batch, single
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# distribution on one card (dist_path) and the opt-in modules (opt_in_path)
# ---------------------------------------------------------------------------

# masks of a distributed generate against one process's (the JAX package's
# sharded-decode tolerance, tests/test_sharded_decode.py)
DIST_MASK_TOL = dict(atol=2e-3, rtol=1e-3)
# The ragged dispatch against the gmm one on one layer (norm-relative):
# it multiplies bf16-dequantized weights where K1 scales f32 sums.
OPT_IN_REL_TOL = 1e-2


def start_rank_pair():
    """The two rank processes of every distributed check, spawned once:
    gloo on cuda:0 (NCCL refuses two ranks on one device; gloo stages
    CUDA tensors through the host). Params and batches reach them through
    CUDA IPC (no copy of a 7B tree)."""
    from medplib_tpu_torch.parallel.dryrun import RankPool
    return RankPool(2, device="cuda:0", backend="gloo", timeout=600,
                    threads=2)


def _rank_prep(shape, params, batch):
    """(mesh, this rank's params shards, its rows of the batch)."""
    import torch
    from medplib_tpu_torch.config import MeshConfig
    from medplib_tpu_torch.parallel import mesh as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = pm.make_mesh(MeshConfig(*shape))
    return (mesh, pm.shard_params(mesh, params),
            pm.host_local_batch_to_global(mesh, batch))


def _rank_serve(dev, shape, params, cfg, batch, new, ep_shard, stream):
    """One rank of the distributed serving checks (W8A8 / W4A8 prefill as
    the main path): generate, and with `stream` stream_prefill -> two
    decode chunks -> stream_ground, each with its launch counts; outputs
    all-gathered over the row shards, on the host."""
    import torch
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.parallel import mesh as pm
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant
    mesh, local, lb = _rank_prep(shape, params, batch)

    def rows(x):
        return mesh.all_gather(x, pm.ROWS).float().cpu()

    out = {}
    with pm.set_mesh(mesh), dynamic_act_quant(True):
        reset_counts()
        t0 = time.time()
        r = medplib.generate(local, cfg, lb, max_new_tokens=new,
                             ep_shard=ep_shard)
        torch.cuda.synchronize()
        out.update(gen_s=time.time() - t0, gen_counts=kernel_counts(),
                   ids=rows(r.output_ids), masks=rows(r.pred_masks),
                   valid=rows(r.seg_valid))
        if stream:
            reset_counts()
            t0 = time.time()
            st = medplib.stream_prefill(local, cfg, lb, new,
                                        ep_shard=ep_shard)
            torch.cuda.synchronize()
            out["prefill_s"] = time.time() - t0
            out["prefill_counts"], chunks, toks = kernel_counts(), [], []
            t0 = time.time()
            for n in (new // 2, new - new // 2):
                reset_counts()
                st, t, _ = medplib.stream_decode_chunk(local, cfg, st, n,
                                                       ep_shard=ep_shard)
                torch.cuda.synchronize()
                chunks.append((n, kernel_counts()))
                toks.append(t)
            out["decode_s"] = time.time() - t0
            masks, valid = medplib.stream_ground(local, cfg, lb, st)
            out.update(chunk_counts=chunks, stream_ids=rows(
                torch.cat(toks, 1)), stream_masks=rows(masks),
                stream_valid=rows(valid))
    _rank_release()
    return out


def _rank_release():
    """A rank gives its cached device memory back at the end of a job (the
    pair lives through the whole run, beside the later phases' trees)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _train_once(params, cfg, tcfg, batch, ep_shard=False, mesh=None):
    """One make_train_step update of `batch` (no microbatch axis) ->
    {loss, grad_norm, LoRA leaves before / after and their clipped
    gradients (Adam's first moment after one update is (1 - beta1) times
    it; whole leaves, host f32), the dropped-entry mask of every sort
    dispatch (over the global batch, host bool), launches, seconds}."""
    import torch
    from medplib_tpu_torch.models.medplib import Batch
    from medplib_tpu_torch.train import trainer
    from medplib_tpu_torch.utils import tree as tree_util
    t_start = time.time()
    state, tx = trainer.create_state(params, tcfg)
    step = trainer.make_train_step(cfg, tcfg, tx, ep_shard=ep_shard)
    reset_counts()
    t0 = time.time()
    setup_s = t0 - t_start
    with count_drops() as dropped:
        new, m = step(state, Batch(*[None if x is None else x[None]
                                     for x in batch]))
        torch.cuda.synchronize()
    secs, counts = time.time() - t0, kernel_counts()

    def lora_leaves(tree):
        if mesh is not None:
            tree = trainer.consolidate(mesh, tree)
        return {"/".join(p): v.float().cpu()
                for p, v in tree_util.leaves_with_paths(tree)
                if p[-1] in ("lora_a", "lora_b")}

    paths = [p for p, _ in tree_util.leaves_with_paths(state.params)]
    mask = (tree_util.leaves(tx.mask) if tx.mask is not None
            else [True] * len(paths))
    grads = {}
    for p, mu in zip([p for p, k in zip(paths, mask) if k],
                     new.opt_state.mu):
        if p[-1] in ("lora_a", "lora_b"):
            if mesh is not None:
                mu = trainer._full(mesh, p, mu)
            grads["/".join(p)] = mu.float().cpu() / (1 - tcfg.beta1)
    t1 = time.time()
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "before": lora_leaves(state.params),
           "after": lora_leaves(new.params), "grads": grads,
           "drops": [d.cpu() for d in dropped], "counts": counts,
           "s": secs}
    out["setup_s"], out["post_s"] = setup_s, time.time() - t1 + (
        t1 - t0 - secs)
    return out


def _rank_train(dev, shape, params, cfg, tcfg, batch, ep_shard):
    from medplib_tpu_torch.parallel import mesh as pm
    t0 = time.time()
    mesh, local, lb = _rank_prep(shape, params, batch)
    prep = time.time() - t0
    with pm.set_mesh(mesh):
        out = _train_once(local, cfg, tcfg, lb, ep_shard, mesh)
    out["rank_s"] = time.time() - t0
    out["prep_s"] = prep
    _rank_release()
    return out


def _update_rel(got, want, key=None) -> float:
    """Relative Frobenius error over the LoRA leaves of the updates
    (after - before), or of got[key] against want[key]."""
    num = den = 0.0
    for k in want["after"]:
        if key is None:
            dw = want["after"][k] - want["before"][k]
            dg = got["after"][k] - got["before"][k]
        else:
            dw, dg = want[key][k], got[key][k]
        num += float(((dg - dw) ** 2).sum())
        den += float((dw ** 2).sum())
    return (num / den) ** 0.5 if den else float("inf")


# A distributed step against one process's, relative Frobenius over the
# LoRA leaves: their reduced gradients within DIST_GRAD_REL_TOL (bf16 sums
# in another order), their updates within DIST_UPDATE_REL_TOL. Adam's
# first update is lr·g / (|g| + eps): the sign of a near-zero gradient
# element flips that element's whole update, ~1% of the lora_b elements
# of the tiny trees of the CPU rehearsal (update rel 2.4e-2 to 7.2e-2 at
# equal loss and gradient norm).
DIST_GRAD_REL_TOL = 1e-2
DIST_UPDATE_REL_TOL = 1e-1


def _same_step(name, got, want):
    import torch
    lrel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    nrel = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    grel = _update_rel(got, want, "grads")
    urel = _update_rel(got, want)
    drops_eq = len(got["drops"]) == len(want["drops"]) and all(
        torch.equal(a, b) for a, b in zip(got["drops"], want["drops"]))
    log(f"[{name}] loss {got['loss']:.6f} vs one process {want['loss']:.6f}"
        f" (rel {lrel:.2e} <= 1e-3), grad norm {got['grad_norm']:.6f} vs "
        f"{want['grad_norm']:.6f} (rel {nrel:.2e} <= 1e-3), LoRA gradient "
        f"rel {grel:.2e} (<= {DIST_GRAD_REL_TOL:g}), LoRA update rel "
        f"{urel:.2e} (<= {DIST_UPDATE_REL_TOL:g}); dropped entries per "
        f"dispatch {[int(d.sum()) for d in got['drops']]} vs "
        f"{[int(d.sum()) for d in want['drops']]}, the same entries "
        f"{drops_eq}; rank step {got['s']:.2f} s, one process "
        f"{want['s']:.2f} s")
    if lrel > 1e-3 or nrel > 1e-3 or grel > DIST_GRAD_REL_TOL \
            or urel > DIST_UPDATE_REL_TOL or not drops_eq:
        raise AssertionError(f"{name}: the distributed step differs from "
                             f"one process")


def ulp_moved(x):
    """x with every element moved one ulp of its dtype up or down (a
    seeded choice per element)."""
    import torch
    g = torch.Generator(device=x.device).manual_seed(11)
    up = torch.rand(x.shape, generator=g, device=x.device) < 0.5
    inf = torch.full_like(x, float("inf"))
    return torch.nextafter(x, torch.where(up, inf, -inf))


def _forced_logits(params, cfg, batch, k, moved=False):
    """f32 logits of the last k positions of the spliced `batch`, weight-
    only linears (the decode arithmetic); moved: every embedding moved one
    ulp first."""
    import torch
    from medplib_tpu_torch.models import llama, medplib
    with torch.no_grad():
        emb, _, mask, _, _ = medplib.splice_batch(params, cfg, batch)
        if moved:
            emb = ulp_moved(emb)
        hidden, _, _ = medplib._llm_forward(params, cfg, emb, mask,
                                            train=False)
        return llama.logits(params["llm"], hidden[:, -k:])


def _rank_forced(dev, shape, params, cfg, batch, k, ref):
    """One rank's teacher-forced logits against `ref` -> (rel err, top-1
    agreement)."""
    from medplib_tpu_torch.parallel import mesh as pm
    mesh, local, lb = _rank_prep(shape, params, batch)
    with pm.set_mesh(mesh):
        got = mesh.all_gather(_forced_logits(local, cfg, lb, k), pm.ROWS)
    out = (rel_err(got, ref),
           float((got.argmax(-1) == ref.argmax(-1)).float().mean()))
    del got
    _rank_release()
    return out


# TP = 2 runs the decode's weight-only linears in another arithmetic
# (column blocks at half the width, row-parallel f32 partial sums), so
# random weights' near-tied greedy choices can flip. It is held by its
# teacher-forced logits against one process's within TP_FLOOR_FACTOR times
# one process's own change under a one-ulp move of the embeddings, with no
# more than TP_FLOOR_FACTOR times that move's top-1 flips plus one, and by
# its greedy tokens: at least as many equal to the main path's as one
# process keeps under a one-ulp move of the embedding table (the main
# path's call again with every table entry moved).
TP_FLOOR_FACTOR = 2.0


def _hold_generate(name, got, ids, masks, what):
    """Log how the gathered outputs agree with one process's; -> whether
    tokens are equal and masks within DIST_MASK_TOL."""
    import torch
    ids, masks = ids.float().cpu(), masks.float().cpu()
    same = float((got["ids"] == ids).float().mean())
    merr = float((got["masks"] - masks).abs().max())
    ok = same == 1.0 and bool(torch.allclose(got["masks"], masks,
                                             **DIST_MASK_TOL))
    log(f"[{name}] tokens equal to {what}: {same * 100:.1f}%; mask max abs "
        f"err {merr:.3e} (atol 2e-3, rtol 1e-3)")
    return ok


def row_count_gemm_witness(dev, cfg):
    """The cause the EP reference rests on: cuBLAS's bf16 products at
    shapes of the flagship's generate, over a B=16 call's rows and over
    its first B=8 rows alone (seeded inputs): the share of those rows'
    outputs that are bit-equal, their largest difference, and each one's
    largest error against an f64 product. -> {name: share}."""
    import torch
    g = torch.Generator(device=dev).manual_seed(3)
    h, v, vis = cfg.llm.hidden_size, cfg.vocab_size_padded, cfg.vision
    out = {}
    for name, m, k, n in (
            ("decode projection (weight-only, dequantized)", 16, h, h),
            ("decode lm_head", 16, h, v),
            ("CLIP MLP in", 16 * (vis.num_patches + 1), vis.hidden_size,
             vis.intermediate_size)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=g, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        full = (x @ w)[:m // 2]
        half = x[:m // 2] @ w
        ref = x[:m // 2].double() @ w.double()
        eq = float((full == half).float().mean())
        log(f"[row-count witness] {name} [{m} | {m // 2}, {k}] @ [{k}, {n}]"
            f" bf16: the first {m // 2} rows {eq * 100:.2f}% bit-equal, max"
            f" |diff| {float((full.float() - half.float()).abs().max()):.3e};"
            f" max error vs f64 {float((full.double() - ref).abs().max()):.3e}"
            f" ({m} rows) / {float((half.double() - ref).abs().max()):.3e} "
            f"({m // 2} rows)")
        out[name] = eq
    return out


def dist_serving(pool, dev, card, params):
    """EP = 2 (mesh (1, 2, 1)) and TP = 2 (mesh (1, 1, 2)) on two gloo
    ranks sharing the card, and NCCL at world size 1, on the main path's
    int4h flagship at full width and depth: B=16 x T_in=48, 10 new tokens,
    W8A8 / W4A8 prefill.

    EP decodes through the expert-parallel gmm (K1, three calls a layer at
    every step, no K2). Each rank's dense layers run its 8 rows, and the
    row count changes cuBLAS's bf16 results (logged here: one process's
    two B=8 calls against its B=16 call, and row_count_gemm_witness), so
    the arithmetic EP must reproduce is one process's on the same row blocks:
    two B=8 calls with K2's eligibility patched off in ops/moe (three K1
    calls a layer at decode); EP must equal them (tokens,
    masks within DIST_MASK_TOL). Its agreement with the B=16 one-process
    calls (three-call and K2 decode, the main path's) is logged: random
    weights leave near-tied greedy choices that a last-bit change flips.
    TP and NCCL hold the main path's call. Every check runs before the
    first failure is raised."""
    from unittest import mock

    import torch
    from medplib_tpu_torch.config import MeshConfig, flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops import moe
    from medplib_tpu_torch.parallel import mesh as pm
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant

    cfg = flagship_cfg(32, moe=True)
    L, NEW = cfg.llm.num_layers, 10
    batch = make_batch(cfg, 16, 48, np.random.default_rng(0), dev)

    def one(b, fused, p=params):
        off = mock.patch.object(moe, "fused_decode_eligible",
                                lambda *a: False)
        with contextlib.nullcontext() if fused else off, \
                dynamic_act_quant(True):
            r = medplib.generate(p, cfg, b, max_new_tokens=NEW)
        torch.cuda.synchronize()
        return r

    main_ref, k1_ref = one(batch, True), one(batch, False)
    blocks = [one(pm.host_local_batch_to_global(
        pm.Mesh(MeshConfig(1, 2, 1), r), batch), False) for r in (0, 1)]
    block_ids = torch.cat([b.output_ids for b in blocks])
    block_masks = torch.cat([b.pred_masks for b in blocks])
    res, failed = {}, []
    # witness of that cause, with no mesh at all: one process's two B=8
    # calls against its one B=16 call, and cuBLAS at the model's shapes
    _hold_generate("row-count witness", {
        "ids": block_ids.float().cpu(), "masks": block_masks.float().cpu()},
        k1_ref.output_ids, k1_ref.pred_masks, "one B=16 call (one process "
        "both, no mesh, three-call K1 decode): two B=8 calls")
    res["gemm_witness"] = row_count_gemm_witness(dev, cfg)
    t0 = time.time()
    ep = pool.run(_rank_serve, (1, 2, 1), params, cfg, batch, NEW, True,
                  True)
    res["ep_s"] = time.time() - t0
    for rank, o in enumerate(ep):
        chunks = [(n, c["gmm_int4h"], c["moe_ffn_decode_int4h"])
                  for n, c in o["chunk_counts"]]
        log(f"[dist EP=2] rank {rank}: generate {o['gen_s']:.2f} s (stream: "
            f"prefill {o['prefill_s']:.2f} s, {NEW} decode steps "
            f"{o['decode_s']:.2f} s); K1 / "
            f"K2 launches: generate {o['gen_counts']['gmm_int4h']} / "
            f"{o['gen_counts']['moe_ffn_decode_int4h']}, stream_prefill "
            f"{o['prefill_counts']['gmm_int4h']} / "
            f"{o['prefill_counts']['moe_ffn_decode_int4h']}, decode chunks "
            f"(steps, K1, K2) {chunks}")
        expect_counts(f"dist EP=2 rank {rank} generate", o["gen_counts"],
                      gmm_int4h=3 * L * (1 + NEW), flash_fwd=L)
        expect_counts(f"dist EP=2 rank {rank} prefill", o["prefill_counts"],
                      gmm_int4h=3 * L, flash_fwd=L)
        for n, c in o["chunk_counts"]:
            expect_counts(f"dist EP=2 rank {rank} decode x{n}", c,
                          gmm_int4h=3 * L * n)
    o = ep[0]
    if not _hold_generate("dist EP=2", o, block_ids, block_masks,
                          "one process on the ranks' row blocks (B=8 "
                          "calls, three-call K1 decode)"):
        failed.append("EP = 2 against one process")
    _hold_generate("dist EP=2", o, k1_ref.output_ids, k1_ref.pred_masks,
                   "one B=16 call, three-call K1 decode")
    _hold_generate("dist EP=2", o, main_ref.output_ids, main_ref.pred_masks,
                   "the main path (B=16, K2 decode)")
    sok = (torch.equal(o["stream_ids"], o["ids"])
           and torch.equal(o["stream_valid"], o["valid"])
           and torch.allclose(o["stream_masks"], o["masks"],
                              **DIST_MASK_TOL))
    log(f"[dist EP=2] stream_prefill -> 2 decode chunks -> stream_ground "
        f"equal to EP generate: {sok}; EP run {res['ep_s']:.1f} s")
    if not sok:
        failed.append("EP = 2 streaming against EP generate")

    t0 = time.time()
    tp = pool.run(_rank_serve, (1, 1, 2), params, cfg, batch, NEW, False,
                  False)
    res["tp_s"] = time.time() - t0
    for rank, o in enumerate(tp):
        log(f"[dist TP=2] rank {rank}: generate {o['gen_s']:.2f} s")
        expect_counts(f"dist TP=2 rank {rank}", o["gen_counts"],
                      gmm_int4h=3 * L, moe_ffn_decode_int4h=L * NEW,
                      flash_fwd=L)
    _hold_generate("dist TP=2", tp[0], main_ref.output_ids,
                   main_ref.pred_masks, "the main path")
    agree = float((tp[0]["ids"] == main_ref.output_ids.float().cpu()
                   ).float().mean())
    table = params["llm"]["embed_tokens"]
    moved = dict(params, llm=dict(params["llm"], embed_tokens=dict(
        table, embedding=ulp_moved(table["embedding"]))))
    tok_floor = float((one(batch, True, moved).output_ids
                       == main_ref.output_ids).float().mean())
    del moved
    rows_eq = (tp[0]["ids"] == main_ref.output_ids.float().cpu()).all(1)
    mask_ok = bool(torch.allclose(tp[0]["masks"][rows_eq],
                                  main_ref.pred_masks.float().cpu()[rows_eq],
                                  **DIST_MASK_TOL))
    # teacher-forced, on the first 8 rows (the row-parallel sums of a
    # weight-only prefill dominate its time): the prompt and the main
    # path's tokens
    rows = slice(0, 8)
    ids = torch.cat([batch.input_ids[rows], main_ref.output_ids[rows].to(
        batch.input_ids.dtype)], 1)
    fb = type(batch)(*[None if x is None else x[rows] for x in batch])
    fb = fb._replace(input_ids=ids, input_mask=torch.ones_like(ids),
                     labels=ids)
    k = NEW + 1
    ref = _forced_logits(params, cfg, fb, k)
    moved = _forced_logits(params, cfg, fb, k, moved=True)
    floor = rel_err(moved, ref)
    floor_agree = float((moved.argmax(-1) == ref.argmax(-1)).float().mean())
    t0 = time.time()
    tf = pool.run(_rank_forced, (1, 1, 2), params, cfg, fb, k, ref)[0]
    log(f"[dist TP=2] greedy tokens {agree * 100:.1f}% equal to the main "
        f"path's (>= {tok_floor * 100:.1f}%, one process's under a one-ulp "
        f"move of the embedding table); masks of the rows with equal "
        f"tokens within tolerance {mask_ok}; teacher-forced logits of the "
        f"{k} generated positions of 8 rows (weight-only, "
        f"{time.time() - t0:.1f} s): "
        f"rel {tf[0]:.3e}, top-1 agreement {tf[1]:.4f}; one process under a"
        f" one-ulp move of the embeddings: rel {floor:.3e}, agreement "
        f"{floor_agree:.4f}")
    res["tp_forced"] = (tf[0], tf[1], floor, floor_agree)
    n_pos = ref.shape[0] * ref.shape[1]
    flips, floor_flips = (round((1 - a) * n_pos) for a in (tf[1],
                                                           floor_agree))
    if (agree < tok_floor or not mask_ok
            or tf[0] > TP_FLOOR_FACTOR * floor
            or flips > TP_FLOOR_FACTOR * floor_flips + 1):
        failed.append("TP = 2 against one process")
    try:
        res["nccl"] = nccl_world1(dev, params, cfg, batch, NEW, main_ref)
    except AssertionError as e:
        failed.append(str(e))
    if failed:
        raise AssertionError("distributed serving: " + "; ".join(failed))
    return res


def nccl_world1(dev, params, cfg, batch, new, ref):
    """NCCL at world size 1: init_distributed and a (1, 1, 1) mesh, the
    three collectives on card tensors (identities), then the main path's
    generate under the mesh (its MoE aux sums run through NCCL): tokens
    equal to the main path's, launches K1 3L, K2 L x new and K4 L."""
    import torch
    import torch.distributed as dist
    from medplib_tpu_torch.config import MeshConfig
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.parallel import mesh as pm
    from medplib_tpu_torch.parallel.dryrun import free_port
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant
    t0 = time.time()
    pm.init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda:0")
    try:
        mesh = pm.make_mesh(MeshConfig(1, 1, 1))
        x = torch.randn(64, 96, device=dev)
        coll = (torch.equal(mesh.all_reduce(x, pm.AXIS_NAMES), x)
                and torch.equal(mesh.all_gather(x, pm.ROWS, dim=1), x)
                and torch.equal(mesh.reduce_scatter(x, "model"), x))
        with pm.set_mesh(mesh), dynamic_act_quant(True):
            reset_counts()
            r = medplib.generate(params, cfg, batch, max_new_tokens=new)
            torch.cuda.synchronize()
        counts, backend = kernel_counts(), dist.get_backend()
    finally:
        dist.destroy_process_group()
    L = cfg.llm.num_layers
    log(f"[dist NCCL world 1] backend {backend}; collectives exact {coll};"
        f" {time.time() - t0:.1f} s with the process group")
    expect_counts("dist NCCL world 1", counts, gmm_int4h=3 * L,
                  moe_ffn_decode_int4h=L * new, flash_fwd=L)
    same = bool(torch.equal(r.output_ids, ref.output_ids))
    log(f"[dist NCCL world 1] tokens equal to the main path: {same}")
    if backend != "nccl" or not coll or not same:
        raise AssertionError("NCCL at world size 1 differs")
    return time.time() - t0


def dist_train_stage3(pool, dev, card, params):
    """DP = 2 (mesh (2, 1, 1)): one stage-3 QLoRA step of train_phase's
    tree (before its first step) at B=8 x 1087 tokens, 4 rows a rank,
    against one process's B=8 step (warmup 0, so the first update moves
    the adapters; LoRA dropout 0.05, whose masks both draw for the whole
    batch): loss and gradient norm within 1e-3, LoRA gradients and updates
    within DIST_GRAD_REL_TOL and DIST_UPDATE_REL_TOL."""
    from medplib_tpu_torch.config import TrainConfig, flagship_cfg
    cfg = flagship_cfg(32, moe=False)
    batch = make_batch(cfg, 8, 512, np.random.default_rng(0), dev)
    tcfg = TrainConfig(lr=1e-4, warmup_steps=0, total_steps=100)
    want = _train_once(params, cfg, tcfg, batch)
    t0 = time.time()
    got = pool.run(_rank_train, (2, 1, 1), params, cfg, tcfg, batch, False)
    log(f"[dist DP=2 stage 3] ranks' job {time.time() - t0:.1f} s (in the "
        f"ranks: mesh and shards {got[0]['prep_s']:.2f} s, state and step "
        f"function {got[0]['setup_s']:.2f} s, the step {got[0]['s']:.2f} s,"
        f" the results {got[0]['post_s']:.2f} s, the whole job "
        f"{got[0]['rank_s']:.1f} s)")
    for rank, g in enumerate(got):
        expect_counts(f"dist DP=2 stage 3 rank {rank}", g["counts"],
                      flash_fwd=64, flash_bwd_dq=32, flash_bwd_dkv=32)
    _same_step("dist DP=2 stage 3", got[0], want)
    return got[0]["s"]


def dist_train_stage4(pool, dev, card, trained):
    """DP = 2 (mesh (2, 1, 1)): one stage-4 step on the trained tree's
    first 2 layers at full width (B=4 x 1087 tokens, 2 rows a rank) with
    a skewed router (skew_router, on copies of the embedding and router)
    so that top-1 at capacity 1.5 drops tokens: the dropped entries of
    every dispatch equal one process's, loss and LoRA updates as stage
    3."""
    from medplib_tpu_torch.config import TrainConfig, flagship_cfg
    cfg = flagship_cfg(2, moe=True)
    llm = layer_slice(trained["llm"], 2)
    llm["embed_tokens"] = {"embedding":
                           llm["embed_tokens"]["embedding"].clone()}
    llm["layers"]["moe"]["router"] = {
        "kernel": llm["layers"]["moe"]["router"]["kernel"].clone()}
    tree = dict(trained, llm=llm)
    skew_router(tree)
    batch = make_batch(cfg, 4, 512, np.random.default_rng(7), dev)
    tcfg = TrainConfig(lr=1e-4, warmup_steps=0, total_steps=100,
                       lora_dropout=0.05)
    want = _train_once(tree, cfg, tcfg, batch)
    got = pool.run(_rank_train, (2, 1, 1), tree, cfg, tcfg, batch, False)
    if not sum(int(d.sum()) for d in want["drops"]):
        raise AssertionError("the skewed router dropped no token")
    _same_step("dist DP=2 stage 4", got[0], want)
    _same_step("dist DP=2 stage 4 rank 1", got[1], want)
    return got[0]["s"]


def opt_in_path(dev, card, params):
    """The opt-in modules on the card: dispatch_mode="ragged" against
    "gmm" (K1) on one full-width MoE layer; the serving worker with
    device_preprocess=True on the front end's 24 PNG images against the
    host path (<= 2/255 before normalize); the native preprocessing
    library built and loaded here, against the numpy path (<= 1/255)."""
    import torch
    from medplib_tpu_torch import native
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.data import preprocess as pp
    from medplib_tpu_torch.models import llama, medplib
    from medplib_tpu_torch.ops import moe
    from medplib_tpu_torch.serve import protocol
    from medplib_tpu_torch.serve import worker as wk

    cfg = flagship_cfg(32, moe=True)
    res = {}
    batch = make_batch(cfg, 16, 48, np.random.default_rng(0), dev)
    with torch.no_grad():
        emb = medplib.splice_batch(params, cfg, batch)[0]
        mp = llama.layer_params(params["llm"]["layers"], 0)["moe"]
        xs, outs, times = emb, {}, {}
        for mode in ("gmm", "ragged"):
            reset_counts()
            t0 = time.time()
            outs[mode] = moe.moe_mlp(mp, xs, cfg.moe, train=False,
                                     dispatch_mode=mode)[0]
            torch.cuda.synchronize()
            times[mode] = time.time() - t0
            if mode == "gmm":
                expect_counts("opt-in gmm layer", kernel_counts(),
                              gmm_int4h=3)
            else:
                expect_counts("opt-in ragged layer", kernel_counts())
        rel = rel_err(outs["ragged"], outs["gmm"])
        log(f"[opt-in ragged] one MoE layer, {xs.shape[0] * xs.shape[1]} "
            f"tokens: rel err vs gmm {rel:.3e} (<= {OPT_IN_REL_TOL:g}); "
            f"ragged {times['ragged']:.3f} s, gmm {times['gmm']:.3f} s "
            f"(first calls, host clock)")
        if rel > OPT_IN_REL_TOL:
            raise AssertionError("the ragged dispatch disagrees with gmm")
        res["ragged"] = rel

    tok = StubTokenizer(cfg.seg_token_idx, cfg.vocab_size_padded)
    dev_w = wk.ModelWorker(cfg, params, tok, device_preprocess=True)
    host_w = wk.ModelWorker(cfg, params, tok)
    worst = [0.0, 0.0]
    t_dev = t_host = 0.0
    imgs = [protocol.decode_image_b64(p["images"][0])
            for p in front_payloads(cfg)]
    for img in imgs:
        t0 = time.time()
        a = dev_w.build_sample("<image>\nhi", img, None)
        t1 = time.time()
        b = host_w.build_sample("<image>\nhi", img, None)
        t_dev, t_host = t_dev + t1 - t0, t_host + time.time() - t1
        if tuple(a["resize_hw"]) != tuple(b["resize_hw"]):
            raise AssertionError("device preprocess: another resize_hw")
        worst[0] = max(worst[0], float((np.abs(a["image_sam"] - b[
            "image_sam"]) * pp.SAM_PIXEL_STD).max()))
        worst[1] = max(worst[1], float((np.abs(a["image_clip"] - b[
            "image_clip"]) * pp.CLIP_STD * 255).max()))
    log(f"[opt-in device preprocess] {len(imgs)} front-end PNGs (512 x 640)"
        f": max |device - host| {worst[0]:.3f} (SAM) / {worst[1]:.3f} "
        f"(CLIP) grey levels (<= 2); {t_dev * 1e3 / len(imgs):.1f} ms / "
        f"{t_host * 1e3 / len(imgs):.1f} ms per image (device / host)")
    if max(worst) > 2.0:
        raise AssertionError("device preprocess differs from the host path")
    res["devpre"] = worst

    t0 = time.time()
    loaded = native.available()
    t_build = time.time() - t0
    nat = [0.0, 0.0]
    for img in imgs[:8]:
        sam_n, _ = pp.preprocess_sam(img)
        clip_n = pp.preprocess_clip(img)
        pp.USE_NATIVE = False
        try:
            sam_p, _ = pp.preprocess_sam(img)
            clip_p = pp.preprocess_clip(img)
        finally:
            pp.USE_NATIVE = True
        nat[0] = max(nat[0], float((np.abs(sam_n - sam_p)
                                    * pp.SAM_PIXEL_STD).max()))
        nat[1] = max(nat[1], float((np.abs(clip_n - clip_p)
                                    * pp.CLIP_STD * 255).max()))
    log(f"[opt-in native] library {native.library_path().name} loaded "
        f"{loaded} ({t_build:.1f} s with its g++ build), used "
        f"{pp._native() is native}; max |native - numpy| {nat[0]:.2e} / "
        f"{nat[1]:.2e} grey levels (<= 1)")
    if not loaded or pp._native() is not native or max(nat) > 1.0:
        raise AssertionError("the native preprocessing library failed")
    res["native"] = nat
    return res


KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "gmm_int4h": ("medplib_tpu_torch/csrc/gmm_int4h.cu",
                  "medplib_tpu/ops/pallas/gmm.py:348"),
    "moe_ffn_decode_int4h": ("medplib_tpu_torch/csrc/moe_decode_int4h.cu",
                             "medplib_tpu/ops/pallas/moe_decode.py:258"),
    "gmm": ("medplib_tpu_torch/csrc/gmm.cu",
            "medplib_tpu/ops/pallas/gmm.py:176"),
    "flash_fwd": ("medplib_tpu_torch/csrc/flash_attention.cu",
                  "medplib_tpu/ops/pallas/flash_attention.py:138"),
    "flash_bwd_dq": ("medplib_tpu_torch/csrc/flash_attention.cu",
                     "medplib_tpu/ops/pallas/flash_attention.py:306"),
    "flash_bwd_dkv": ("medplib_tpu_torch/csrc/flash_attention.cu",
                      "medplib_tpu/ops/pallas/flash_attention.py:333"),
    "int8_matmul": ("medplib_tpu_torch/csrc/int8_matmul.cu",
                    "medplib_tpu/ops/pallas/int8_matmul.py:91"),
    "w8a8_matmul": ("medplib_tpu_torch/csrc/int8_matmul.cu",
                    "medplib_tpu/ops/pallas/int8_matmul.py:234"),
    "int4h_matmul": ("medplib_tpu_torch/csrc/int4_matmul.cu",
                     "medplib_tpu/ops/pallas/int4_matmul.py:144"),
    **{n: ("medplib_tpu_torch/csrc/moe_prefill_quant.cu",
           "none (XLA's fusions around the Pallas gmm)")
       for n in PREFILL_PASSES},
}


def main() -> int:
    global PROFILES
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--profiles"]:
        PROFILES = True
    elif sys.argv[1:] and sys.argv[1] not in ("--k2-equal-share",
                                              "--icl-profile",
                                              "--stage4-step"):
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--k2-equal-share"]:
        k2_equal_share(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--icl-profile"]:
        icl_profile(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--stage4-step"]:
        stage4_step(sys.argv[2], *[int(a) for a in sys.argv[3:4]])
        return 0
    sys.path.insert(0, HERE)
    from medplib_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; TF32 off (matmul and cuDNN)")
    import importlib.util
    log("[device] installed here (the serving worker path needs none): " +
        ", ".join(f"{m} {importlib.util.find_spec(m) is not None}"
                  for m in ("PIL", "requests", "cv2", "transformers")))

    t_run = t_lap = time.time()

    def lap(what):
        """Log the phase's seconds, then collect garbage: reference cycles
        (threads, servers, closures of a phase) can hold a 7B tree until
        a full collection, which would inflate the next phase's peak."""
        nonlocal t_lap
        gc.collect()
        torch.cuda.empty_cache()
        now = time.time()
        log(f"[time] {what}: {now - t_lap:.1f} s (run {now - t_run:.1f} s)")
        t_lap = now

    t0 = time.time()
    _build.load_library()
    log(f"[build] {time.time() - t0:.1f} s -> {_build.library_path()}\n"
        f"{_build.build_log.strip()}")
    sass_phase(_build.library_path(), _build.build_log)
    lap("build and SASS counts")
    # the distributed checks' two rank processes start now, so that their
    # start-up overlaps the kernel phases
    pool = start_rank_pair()
    try:
        return _phases(dev, card, lap, t_run, pool)
    finally:
        pool.close()


def _phases(dev, card, lap, t_run, pool) -> int:
    """Every phase after the build, then the result lines."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    k1_phase(gen, dev, results)
    k2_phase(gen, dev, results)
    k3_phase(gen, dev, results)
    k7_phase(gen, dev, results)
    k8_phase(gen, dev, results)
    k9_phase(gen, dev, results)
    ragged_phase(gen, dev)
    flash_phase(gen, dev, results)
    moe_prefill_phase(gen, dev, results)
    torch.cuda.empty_cache()
    lap("kernel phases")
    small_check(dev)
    small_int8_check(dev)
    small_packed_check(dev, 8)
    small_packed_check(dev, 4)
    small_region_checks(dev)
    train_check(dev)
    moe_train_check(dev)
    cli_check(dev)
    small_engine_check(dev)
    small_worker_check(dev)
    small_export_check(dev)
    small_mpt_check(dev)
    lap("small card-vs-CPU checks")
    masks_per_s, peak, params = main_path(dev, results, card)
    lap("main path")
    dist = dist_serving(pool, dev, card, params)
    lap("distributed serving (EP = 2, TP = 2, NCCL world 1)")
    optin = opt_in_path(dev, card, params)
    lap("opt-in modules")
    engine = engine_path(dev, results, card, params)
    lap("engine path")
    t0 = time.time()
    front = worker_path(dev, card, params, engine["E1"]["tok_s"])
    log(f"[W1, W2] done in {time.time() - t0:.1f} s")
    lap("front end")
    evr = eval_path(dev, card, params)
    del params
    torch.cuda.empty_cache()
    lap("eval path")
    region = region_path(dev, results, card)
    torch.cuda.empty_cache()
    lap("region path")
    int8 = int8_path(dev, results, card)
    torch.cuda.empty_cache()
    lap("int8 path")
    packed = packed_path(dev, results, card)
    lap("packed path")
    keep = {}
    tokens_per_s, train_peak = train_phase(dev, results, card, keep)
    torch.cuda.empty_cache()
    lap("stage-3 training")
    dist["dp3_s"] = dist_train_stage3(pool, dev, card, keep.pop("params"))
    lap("distributed stage-3 step (DP = 2)")
    stage4 = moe_train_phase(dev, card, keep_params=True)
    lap("stage-4 training")
    dist["dp4_s"] = dist_train_stage4(pool, dev, card, stage4["params"])
    lap("distributed stage-4 step (DP = 2)")
    exp = export_path(dev, card, stage4.pop("params"), masks_per_s)
    torch.cuda.empty_cache()
    lap("export path")
    mptr = mpt_path(dev, card)
    lap("mpt path")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    **{k: results[n][k] for k in keys},
                    **{k: results[n][k] for k in ("serve", "topk",
                                                   "flagship")
                       if k in results[n]})
               for n, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[result] serving int4h B=16 {masks_per_s:.3f} masks/s, peak "
          f"{peak:.2f} GiB; config 3 (bf16, compressor, region) B=2 "
          f"{region['cfg3_ms']:.1f} ms/sample, peak "
          f"{region['cfg3_peak']:.2f} GiB; sampled region VQA int4h B=16 "
          f"{region['masks_per_s']:.3f} masks/s, peak {region['peak']:.2f} "
          f"GiB; int8 B=8 {int8['masks_per_s']:.3f} masks/s, "
          f"peak {int8['peak']:.2f} GiB; ICL B=4 "
          f"{int8['icl_ms_per_sample']:.1f} ms/sample, peak "
          f"{int8['icl_peak']:.2f} GiB; packed dense int8 B=16 "
          f"{packed[8][0]:.3f} masks/s, peak {packed[8][1]:.2f} GiB; packed "
          f"dense int4h B=12 {packed[4][0]:.3f} masks/s, peak "
          f"{packed[4][1]:.2f} GiB; training {tokens_per_s:.1f} "
          f"tokens/s, peak {train_peak:.2f} GiB; stage-4 MoE training "
          f"B=4 x ga 8 {stage4['tok_s']:.1f} tokens/s, peak "
          f"{stage4['peak']:.2f} GiB, validation {stage4['val_s']:.3f} "
          f"s/batch (giou {stage4['giou']:.4f}, ciou {stage4['ciou']:.4f}, "
          f"dice {stage4['dice']:.4f}, loss {stage4['loss']:.4f}); engine E1 "
          f"{engine['E1']['tok_s']:.3f} tok/s, {engine['E1']['req_s']:.3f} "
          f"req/s, peak {engine['E1']['peak']:.2f} GiB; E2 "
          f"{engine['E2']['tok_s']:.3f} tok/s, {engine['E2']['req_s']:.3f} "
          f"req/s; E3 TTFT p50 {engine['E3']['ttft_p50']:.1f} ms, p99 "
          f"{engine['E3']['ttft_p99']:.1f} ms, stall max "
          f"{engine['E3']['stall_ms']:.1f} ms "
          f"({engine['E3']['stall_chunks']:.2f} chunks); front end W1 via "
          f"web {front['web']['tok_s']:.3f} tok/s, "
          f"{front['web']['req_s']:.3f} req/s, TTFT p50 "
          f"{front['web']['ttft_p50']:.1f} / p99 "
          f"{front['web']['ttft_p99']:.1f} ms; straight to the worker "
          f"{front['stream']['tok_s']:.3f} tok/s, TTFT p50 "
          f"{front['stream']['ttft_p50']:.1f} / p99 "
          f"{front['stream']['ttft_p99']:.1f} ms; preprocessing "
          f"{front['pre_ms']:.1f} ms/image; W2 sequential "
          f"{front['w2_s']:.3f} s/request; evaluation B=16 seg "
          f"{evr['seg_s']:.4f} / vqa {evr['vqa_s']:.4f} s/sample; RAG "
          f"index {evr['rag_img_s']:.2f} images/s; AMG "
          f"{evr['amg_masks_s']:.2f} masks/s; export (stage-4 tree merged, "
          f"int4h) B=16 {exp['masks_s']:.3f} masks/s (main path "
          f"{masks_per_s:.3f}), merged logits rel err {exp['rel']:.3e}, "
          f"top-1 agreement {exp['agree']:.4f}, CLI round trip "
          f"{exp['cli_s']:.1f} s; MPT-7B greedy B=4 {mptr['tok_s']:.1f} "
          f"new tokens/s, peak {mptr['peak']:.2f} GiB; distributed checks "
          f"(two gloo ranks on one card, no speed claim): EP=2 "
          f"{dist['ep_s']:.1f} s, TP=2 {dist['tp_s']:.1f} s, NCCL world 1 "
          f"{dist['nccl']:.1f} s, DP=2 steps {dist['dp3_s']:.2f} / "
          f"{dist['dp4_s']:.2f} s; opt-in ragged rel err "
          f"{optin['ragged']:.2e}; run "
          f"{time.time() - t_run:.1f} s; {card}",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
