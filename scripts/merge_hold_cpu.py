#!/usr/bin/env python3
"""How far a LoRA merge moves the teacher-forced logits of a bf16
MedPLIB-style MoE tree with random weights, on the CPU (the port,
medplib_tpu_torch; no JAX).

    python3 scripts/merge_hold_cpu.py [--hidden 512] [--layers 32]
        [--vocab 32320] [--tokens 128] [--threads 8]

Builds chip_smoke.init_stage4's tree at the given width and depth (2
experts on every layer, top-1, eval capacity 2.0; tiny CLIP and SAM),
LoRA r=8 on q / v with lora_b ~ N(0, 3e-4) (the size a few Adam steps at
lr 1e-4 give), merges it (utils/export.merge_lora) and prints, for one
B=2 batch, the norm-relative error and the top-1 agreement of:
merged vs unmerged in bf16; the same two trees computed in float32; and
the unmerged tree's bf16 logits vs its float32 logits (the bf16 noise
floor). chip_smoke.MERGE_REL_TOL and MERGE_MIN_AGREE come from these
numbers.
"""

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from medplib_tpu_torch.config import MoeConfig  # noqa: E402
from medplib_tpu_torch.ops.initializers import normal  # noqa: E402
from medplib_tpu_torch.train import lora  # noqa: E402
from medplib_tpu_torch.utils.export import merge_lora  # noqa: E402
from medplib_tpu_torch.utils.hf_weights import cast_tree  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=32320)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--threads", type=int, default=8)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    cfg = cs.tiny_serving_cfg(a.hidden, max(a.hidden // 64, 1))
    llm = dataclasses.replace(cfg.llm, num_layers=a.layers,
                              intermediate_size=2 * a.hidden,
                              vocab_size=a.vocab)
    cfg = dataclasses.replace(
        cfg, llm=llm, vocab_size_padded=a.vocab, seg_token_idx=a.vocab - 12,
        moe=MoeConfig(enable=True, num_experts=2, top_k=1,
                      capacity_factor=1.5, eval_capacity_factor=2.0,
                      moe_mode="dense"))
    gen = torch.Generator().manual_seed(0)
    p = cast_tree(cs.init_stage4(cfg, gen, "cpu"), torch.bfloat16)
    p["llm"] = lora.inject(gen, p["llm"], ("q_proj", "v_proj"), r=8)
    for n in ("q_proj", "v_proj"):
        node = p["llm"]["layers"]["attn"][n]
        node["lora_b"] = normal(gen, node["lora_b"].shape,
                                node["lora_b"].dtype, "cpu", 3e-4)
    m = merge_lora(p)
    b = cs.make_batch(cfg, 2, a.tokens, np.random.default_rng(0), "cpu")
    lu, _ = cs.teacher_forced_logits(p, cfg, b)
    lm, _ = cs.teacher_forced_logits(m, cfg, b)
    lfu, _ = cs.teacher_forced_logits(cast_tree(p, torch.float32), cfg, b)
    lfm, _ = cs.teacher_forced_logits(cast_tree(m, torch.float32), cfg, b)

    def rel(x, y):
        return float((x - y).norm() / y.norm())

    def agree(x, y):
        return float((x.argmax(-1) == y.argmax(-1)).float().mean())

    print(f"hidden {a.hidden}, {a.layers} layers, vocabulary {a.vocab}, "
          f"B=2 x {lu.shape[1]} tokens; merge kernel hold "
          f"{cs.merge_kernel_hold(p, m):.3f}")
    for name, x, y in (("bf16 merged vs unmerged", lm, lu),
                       ("f32 merged vs unmerged", lfm, lfu),
                       ("unmerged bf16 vs f32", lu, lfu)):
        print(f"{name}: rel err {rel(x, y):.3e}, top-1 agreement "
              f"{agree(x, y):.4f}")


if __name__ == "__main__":
    main()
