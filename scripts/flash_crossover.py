"""Time causal prefill attention on an NVIDIA card: kernel K4 (through
ops/cuda/flash_attention.flash_attention) against the plain path
(ops/attention.make_causal_bias + _plain_attention), forward alone and
forward with backward under autograd, in bfloat16 at H = 32, D = 128.

    python3 scripts/flash_crossover.py [--out FILE]

The keep masks are right-padded int32 [B, S] masks, as the serving path
builds them: the B row lengths are evenly spaced from T * 623 / 687 up to
T (the spread of the grounded-VQA batch, 623-687 spliced tokens). Each
time is the mean over CUDA events around repeated calls after a warm-up;
each case also reports the largest relative difference of the two
outputs (and of the gradients) over the kept query rows. Prints one JSON
line per case and writes all of them, with the card's name and power
limit, to FILE (default chiprun_out/flash_crossover.json).

This is the sweep the route was set from; chip_smoke.py's flash_phase
checks K4 at the serving shapes against its plain version and times it
there beside the plain path on every smoke run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_time, gpu_line, rel_err  # noqa: E402

H, D = 32, 128
BATCHES = (1, 16)
LENGTHS = (16, 64, 128, 256, 512, 687, 1024)


def keep_mask(b: int, t: int, dev):
    """[B, T] int32, row i keeps its first n_i keys, n evenly spaced from
    round(T * 623 / 687) to T."""
    import torch
    lo = max(1, round(t * 623 / 687))
    lens = torch.linspace(lo, t, b).round().long() if b > 1 else \
        torch.tensor([t])
    pos = torch.arange(t)[None, :]
    return (pos < lens[:, None]).to(torch.int32).to(dev)


def event_ms(fn, budget_ms: float = 150.0) -> float:
    """Mean ms a call: 3 warm-up calls and one timed call to size the run,
    then CUDA events around enough calls to fill about budget_ms."""
    once = cuda_time(fn, warmup=3, iters=1)
    return cuda_time(fn, warmup=0,
                     iters=int(min(200, max(5, budget_ms / max(once, 1e-3)))))


def _rel(a, w, rows):
    return rel_err(a.detach()[rows], w.detach()[rows])


def case(b: int, t: int, dtype, dev, gen) -> dict:
    import torch

    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    q, k, v, g = (torch.randn((b, t, H, D), generator=gen, device=dev)
                  .to(dtype) for _ in range(4))
    mask = keep_mask(b, t, dev)

    def flash(q, k, v):
        return FA.flash_attention(q, k, v, attn_mask=mask, causal=True)

    def plain(q, k, v):
        bias = A.make_causal_bias(mask, t, t, device=dev)
        return A._plain_attention(q, k, v, bias)

    def fwd_bwd(fn):
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = fn(qq, kk, vv)
        return (out,) + torch.autograd.grad(out, (qq, kk, vv), g)

    rows = mask.bool()             # query rows of real tokens
    n0 = FA.flash_forward.launches
    got, want = fwd_bwd(flash), fwd_bwd(plain)
    torch.cuda.synchronize()
    assert FA.flash_forward.launches == n0 + 1
    row = {"B": b, "T": t, "dtype": str(dtype).split(".")[-1],
           "rel_out": _rel(got[0], want[0], rows),
           "rel_grad": max(_rel(x, w, rows)
                           for x, w in zip(got[1:], want[1:]))}
    with torch.no_grad():
        row["fwd_flash_ms"] = event_ms(lambda: flash(q, k, v))
        row["fwd_plain_ms"] = event_ms(lambda: plain(q, k, v))
    row["fwdbwd_flash_ms"] = event_ms(lambda: fwd_bwd(flash))
    row["fwdbwd_plain_ms"] = event_ms(lambda: fwd_bwd(plain))
    row["fwd_speedup"] = row["fwd_plain_ms"] / row["fwd_flash_ms"]
    row["fwdbwd_speedup"] = row["fwdbwd_plain_ms"] / row["fwdbwd_flash_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/flash_crossover.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_crossover: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from medplib_tpu_torch.ops.cuda._build import load_library
    load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    cases = [(b, t, torch.bfloat16) for b in BATCHES for t in LENGTHS]
    cases.append((16, 687, torch.float32))     # the FMA kernels, for contrast
    for b, t, dtype in cases:
        rows.append(case(b, t, dtype, dev, gen))
        print(json.dumps(rows[-1]), flush=True)
    out = {"card": gpu_line(), "torch": torch.__version__, "H": H, "D": D,
           "cases": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"card": out["card"], "n": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
