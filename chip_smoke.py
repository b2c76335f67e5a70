#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (medplib_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-equal-share ROOT   (K2 alone, see
                                                   k2_equal_share)
    python3 chip_smoke.py --icl-profile ROOT      (ICL config 5 alone, see
                                                   icl_profile)

1. Requires a CUDA device (exits non-zero otherwise) and prints the card's
   name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from medplib_tpu_torch/csrc with nvcc
   and counts, with cuobjdump, the tensor-core instructions of each
   instance of the tensor-core kernels (HMMA: K7 on bf16 x, K3 int8-w /
   bf16, K9 and K1 on bf16 x, K2 on bf16 x, K4 / K5 / K6 on bf16; IMMA:
   K8, K3 W8A8, K1 W4A8, K2 A8).
3. Kernel phases: each kernel at the shapes its main path gives it (K1,
   K2 in A8 and bf16-x modes at the flagship serving shapes, K2 also at
   block_n 128 / 256 / 512 and at B=80 rows; K3 in W8A8 at the int8-expert flagship shapes, int8-w and
   float bf16 at the ICL shapes, transposed at a small shape; K7
   int8_matmul and K9 int4h_matmul at the packed dense serving shapes,
   prefill and decode, both layouts; K8 w8a8_matmul, on no path, at the
   dense W8A8 shapes; K4, K5, K6 at the stage-3 training shape, K4 also
   at the ICL shape) against
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
   equal; and two QLoRA train steps of a tiny model with head_dim 128 and
   a 1039-token spliced row (flash route).
5. Serving main paths, MedPLIB-7b-2e at full width (32 layers x 2
   experts, int8 attention / lm_head / projector), random weights from a
   seed: with int4h experts, a batch of 16 grounding requests (T_in=48,
   10 new tokens, W8A8 / W4A8 prefill; K1 = 96, K2 = 320 launches), one
   profiled call and one single request (K2 only); with int8 experts, a batch of 8 (int8 KV
   cache, W8A8 prefill; K3 = 96 launches), one profiled call and a single
   request (no K3), then ICL config 5 on the same tree (B=4, three images
   per row, 1789 spliced tokens, no activation quant; K3 = 96, K4 = 32,
   one profiled call).
   Released checkpoint -> sampled region VQA (region_path): the bf16
   flagship with the 576 -> 256 compressor and the region adapter turned
   into a released-layout state dict (utils/hf_export.medplib_to_hf) and
   loaded back (utils/export.load_reference_checkpoint), leaf for leaf
   equal; run_all.py config 3 on it (B=2, region marker, compressor,
   ground=False, 16 new tokens; no kernel launch: sort prefill, no fused
   decode for bf16 experts, rows under the flash gate); then the tree
   quantized for serving (int4h experts) and a batch of 16 region
   requests, half sampled from per-row seeds, half greedy (K1 = 96, K2 =
   320, one profiled call; repeat calls equal, other seeds move only
   sampled rows) and one request (K2 = 320).
   Then packed dense serving (the dense MedPLIB-7B, pack_inference): int8
   B=16 under W8A8 (K7 = 704) and int4h B=12 (K9 = 704), each with one
   profiled call and a single request after it.
   Each path runs with every launch count set to 0 just before it and
   read just after; each checks the outputs and repeatability and prints
   masks/s or ms/sample and peak memory.
Any failed phase raises; the line before the last is the card's name and
power limit, the last stdout line, printed only on success, is
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


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def sass_phase(lib_path, build_log: str) -> None:
    """cuobjdump --dump-sass of the built library: the tensor-core
    instructions in each instance of the tensor-core kernels (HMMA in
    w8_mma_kernel: K7 on bf16 x, K3 int8-w / bf16; int4h_mma_kernel: K9 on
    bf16 x (int4_matmul.cu, 8 instances) and K1 on float x (gmm_int4h.cu,
    2); flash_fwd_mma_kernel, flash_dq_mma_kernel and
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
            "flash_fwd_mma_kernel": 1, "flash_dq_mma_kernel": 1,
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
    the share of bit-equal elements printed."""
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
    profile_step(run, top=6)


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
    ("W8A8", 700, 1024, 768, True),
    ("int8-w", 700, 1024, 768, True),
]


def k3_phase(gen, dev, results):
    """gmm (K3) against gmm_plain, TF32 off, at the shapes its main paths
    give it: W8A8 at the int8-expert flagship prefill (S = 8 x 623 rows
    top-1 routed over 2 experts, two-ended aligned to Sp = 5632, bm 512;
    gate/up K 4096 -> N 11264 and down K 11264 -> N 4096); int8-w (bf16 x)
    at the ICL prefill (S = 4 x 1789, Sp = 7680), both shapes; float bf16
    at the ICL gate/up shape; transposed weights (W8A8 and int8-w) at a
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


def _flash_inputs(gen, dev, b, t, s, h, d):
    import torch
    bf = torch.bfloat16
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf)
    k = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf)
    v = torch.randn((b, s, h, d), generator=gen, device=dev).to(bf)
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    for i in range(b):          # padded tails of 0..70 keys
        mask[i, s - 10 * i:] = 0
    if t == s:
        mask[1, :5] = 0         # row 1's first 5 queries keep no key
    dout = torch.randn((b, t, h, d), generator=gen, device=dev).to(bf)
    return q, k, v, mask, dout


# mma FLOP a kept (query, key) pair, in units of D: what the table counts
# (S, then P V / dP and dS K / dP, P^T dO and dS^T Q) and what the bf16
# tensor-core kernels run (the P / dS products twice: hi + lo)
FLASH_FLOP_D = {"flash_fwd": (4, 6), "flash_bwd_dq": (6, 8),
                "flash_bwd_dkv": (8, 12)}


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
    return {"gmm_int4h": G.gmm_int4h,
            "moe_ffn_decode_int4h": D.moe_ffn_decode_int4h, "gmm": G.gmm,
            "flash_fwd": FA.flash_forward, "flash_bwd_dq": FA.flash_dq,
            "flash_bwd_dkv": FA.flash_dkv,
            "int8_matmul": I8.int8_matmul_2d,
            "w8a8_matmul": I8.w8a8_matmul_2d,
            "int4h_matmul": I4.int4h_matmul_2d}


def reset_counts() -> None:
    for f in _wrappers().values():
        f.launches = 0


def kernel_counts() -> dict:
    return {n: f.launches for n, f in _wrappers().items()}


def flash_counts():
    c = kernel_counts()
    return (c["flash_fwd"], c["flash_bwd_dq"], c["flash_bwd_dkv"])


def expect_counts(where: str, got: dict, **want) -> None:
    """Fail unless every named kernel launched exactly `want` times (the
    kernels not named: none)."""
    want = {n: want.get(n, 0) for n in got}
    log(f"[{where}] launches {got} (want {want})")
    if got != want:
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
                      gen_kw=None, **want):
    """Generate (by default B=16 x T_in=64: 1264 spliced tokens; 4 new
    tokens; W8A8 prefill with actq) with the same tiny params `host` (a
    numpy tree) on the CPU (plain versions) and on the card (kernels);
    tokens and masks must agree and the card must launch exactly `want`.
    make(where) builds another batch; gen_kw adds generate arguments."""
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
            r = medplib.generate(tree_from_numpy(host, where), cfg, b,
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
                      False, gmm_int4h=6, moe_ffn_decode_int4h=8)


def small_int8_check(dev):
    """int8 experts at H = M = 1024 (multiples of 1024: the whole-stack
    int8 gmm engages), int8 KV cache: K3 at prefill, sort path at
    decode."""
    cfg = tiny_serving_cfg(1024, 16)
    _tiny_card_vs_cpu(dev, "small int8 check", cfg, _tiny_moe_tree(cfg, 8),
                      True, gmm=6)


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
    llm = C.LlamaConfig(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=2,
                        num_kv_heads=2, head_dim=128)
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
        projector=C.ProjectorConfig(mm_hidden_size=64, hidden_size=256),
        seg=C.SegConfig(out_dim=32), seg_token_idx=500,
        vocab_size_padded=512)
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


def profile_step(fn, top: int = 14) -> None:
    """One call of `fn` under torch.profiler (CPU + CUDA): prints the wall
    time, the summed time of the device's kernels (on one stream they do
    not overlap, so 1 - sum / wall is the device's idle share) and the
    kernels that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    from torch.autograd import DeviceType
    rows, stalls = [], 0.0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue           # host ops (their kernels are listed apart)
        if e.key == "Command Buffer Full":
            stalls += us / 1e6
        else:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] wall {wall:.3f} s under the profiler, kernels "
        f"{busy:.3f} s (idle share {max(0.0, 1 - busy / wall):.3f}; "
        f"'Command Buffer Full' {stalls:.3f} s); top kernels:")
    for us, n, key in rows[:top]:
        log(f"[profile]   {us / 1e3:9.1f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"{n:6d} x  {key[:110]}")


def train_phase(dev, results, card):
    """The stage-3 QLoRA train step at full width (bench_train's config):
    dense LLaMA-7B + CLIP ViT-L/14-336 + SAM-Med2D ViT-B, bf16 init on the
    card from a seeded generator, the LLM int8, LoRA q/v r=8 with dropout
    0.05, B=8 x T_in=512 (1087 spliced tokens), remat; one warm-up step
    and three timed ones (host clock ending in a synchronize)."""
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
        gmm_int4h=3 * L, moe_ffn_decode_int4h=L * NEW)
    for n in ("gmm_int4h", "moe_ffn_decode_int4h"):
        results[n]["launches"] = counts[n]
    profile_step(lambda: run(batch))
    # B=1: 623 tokens take the capacity-sort prefill; decode still K2
    serve_single("main", lambda: run(single), cfg, NEW,
                 moe_ffn_decode_int4h=L * NEW)
    return masks_per_s, peak


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

    per_s3, peak3, _ = serve_batch("config 3", run3, cfg, B3, NEW3, card)
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
        gmm_int4h=3 * L, moe_ffn_decode_int4h=L * NEW)
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
                 NEW, moe_ffn_decode_int4h=L * NEW)
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
        gmm=3 * L)
    results["gmm"]["launches"] = counts["gmm"]
    profile_step(lambda: run(cfg, batch, True, True))
    serve_single("int8", lambda: run(cfg, single, True, True), cfg, NEW)

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
                                          NEW, card, **{kernel: want})
        results[kernel]["launches"] = counts[kernel]
        profile_step(lambda: run(batch))
        serve_single(name, lambda: run(single), cfg, NEW, **{kernel: want})
        out[bits] = (per_s, peak)
        del params, batch, single
        torch.cuda.empty_cache()
    return out


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
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--k2-equal-share"]:
        k2_equal_share(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--icl-profile"]:
        icl_profile(sys.argv[2])
        return 0
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
    sass_phase(_build.library_path(), _build.build_log)

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
    torch.cuda.empty_cache()
    small_check(dev)
    small_int8_check(dev)
    small_packed_check(dev, 8)
    small_packed_check(dev, 4)
    small_region_checks(dev)
    train_check(dev)
    masks_per_s, peak = main_path(dev, results, card)
    torch.cuda.empty_cache()
    region = region_path(dev, results, card)
    torch.cuda.empty_cache()
    int8 = int8_path(dev, results, card)
    torch.cuda.empty_cache()
    packed = packed_path(dev, results, card)
    tokens_per_s, train_peak = train_phase(dev, results, card)

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    **{k: results[n][k] for k in keys})
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
          f"tokens/s, peak {train_peak:.2f} GiB; {card}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
