"""Interactive chat CLI with pixel grounding (medplib_tpu/chat.py): a REPL
over a conversation template, dual SAM / CLIP image preprocessing,
generation with <SEG>-driven mask decode, and the prediction mask and its
overlay saved as JPEGs per turn.

Usage:
  python -m medplib_tpu_torch.chat --checkpoint <params file> \\
      --tokenizer <hf tokenizer dir> [--moe] [--precision bf16] \\
      [--device cuda]

The params file is one torch.save tree (utils/checkpoint.save_params);
`--checkpoint random` initializes random weights from seed 0. transformers
(the tokenizer) and Pillow (the JPEGs) are imported where they are used.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    ap = argparse.ArgumentParser(description="MedPLIB chat (PyTorch)")
    ap.add_argument("--checkpoint", required=True,
                    help="params file written by utils/checkpoint."
                         "save_params, or 'random'")
    ap.add_argument("--tokenizer", required=True,
                    help="HF tokenizer path (llava-v1.5 vocab + extra tokens)")
    ap.add_argument("--conv-type", default="v1",
                    choices=["v1", "llava_v1", "llava_llama_2"])
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32"])
    ap.add_argument("--load-in-8bit", action="store_true",
                    help="weight-only int8 (visual modules skipped)")
    ap.add_argument("--load-in-4bit", action="store_true",
                    help="weight-only int4h, group-scaled nibbles")
    ap.add_argument("--moe", action="store_true",
                    help="MoE checkpoint (MedPLIB-7b-2e layout)")
    ap.add_argument("--vis-save-path", default="./vis_output")
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; < 1e-4 = greedy")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (applies when sampling)")
    ap.add_argument("--seed", type=int, default=0, help="sampling RNG seed")
    ap.add_argument("--sam-img-size", type=int, default=256)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model config for CPU smoke / debug")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cpu)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch
    from transformers import AutoTokenizer

    from medplib_tpu_torch.config import (MedplibConfig, MoeConfig,
                                          tiny_cli_config)
    from medplib_tpu_torch.data import preprocess as pp
    from medplib_tpu_torch.data import tokenize as tk
    from medplib_tpu_torch.data.conversation import conv_templates
    from medplib_tpu_torch.data.dataset import (CollatorConfig, collate,
                                                to_model_batch)
    from medplib_tpu_torch.eval.seg_metrics import binarize_logits
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.checkpoint import load_params
    from medplib_tpu_torch.utils.hf_weights import cast_tree

    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    tk.add_special_tokens(tokenizer)
    seg_idx = tokenizer.convert_tokens_to_ids("<SEG>")

    moe_cfg = MoeConfig(enable=args.moe, num_experts=2, top_k=1,
                        capacity_factor=1.5, eval_capacity_factor=2.0,
                        moe_mode="dense")
    if args.tiny:
        cfg = tiny_cli_config(moe_cfg, seg_idx, len(tokenizer))
    else:
        cfg = MedplibConfig(moe=moe_cfg, seg_token_idx=seg_idx,
                            vocab_size_padded=len(tokenizer))
    dev = torch.device(args.device)
    if args.checkpoint == "random":
        params = medplib.init_medplib(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    else:
        params = load_params(args.checkpoint, device=dev)
    if args.precision == "bf16":
        params = cast_tree(params, torch.bfloat16)
    if args.load_in_4bit or args.load_in_8bit:
        from medplib_tpu_torch.utils.quantize import quantize_tree
        params = quantize_tree(params, bits=4 if args.load_in_4bit else 8)

    cc = CollatorConfig(max_seq_len=512,
                        image_tokens=medplib.image_tokens_per_image(cfg),
                        sam_image_size=cfg.sam.image_size,
                        clip_image_size=cfg.vision.image_size)
    do_sample = args.temperature >= 1e-4

    os.makedirs(args.vis_save_path, exist_ok=True)
    conv_template = conv_templates[args.conv_type]
    turn = 0
    while True:
        conv = conv_template.copy()
        try:
            prompt = input("Please input your prompt: ")
        except EOFError:
            break
        if not prompt:
            continue
        image_path = input("Please input the image path: ")
        if not os.path.exists(image_path):
            print(f"File not found: {image_path}")
            continue

        conv.append_message(conv.roles[0], "<image>\n" + prompt)
        conv.append_message(conv.roles[1], None)
        full_prompt = conv.get_prompt()

        rgb = pp.load_image_rgb(image_path)
        image_sam, resize_hw = pp.preprocess_sam(rgb, cfg.sam.image_size)
        ids = np.asarray(tk.tokenizer_image_token(full_prompt, tokenizer),
                         np.int64)
        sample = {
            "input_ids": ids, "labels": np.full(len(ids), -100, np.int64),
            "image_clip": pp.preprocess_clip(rgb, cfg.vision.image_size),
            "image_sam": image_sam, "resize_hw": resize_hw,
            "original_hw": rgb.shape[:2], "gt_masks": [],
            "gt_masks_original": [], "question": [prompt], "gt": [""],
            "image_path": image_path, "answer_type": None,
        }
        arrays, _ = collate([sample], cc)
        # one sampling stream per (seed, turn)
        res = medplib.generate(
            params, cfg, to_model_batch(arrays, dev),
            max_new_tokens=args.max_new_tokens,
            eos_id=tokenizer.eos_token_id or 2, do_sample=do_sample,
            temperature=args.temperature, top_p=args.top_p,
            rng=[(args.seed << 32) | turn])
        n = int(res.num_generated[0])
        toks = [t for t in res.output_ids[0][:n].tolist() if t > 0]
        text = tokenizer.decode(toks, skip_special_tokens=False).replace(
            "</s>", "").strip()
        print("ASSISTANT:", text)

        if bool(res.has_seg[0]):
            logits = res.pred_masks[0, 0].float().cpu().numpy()
            pred = pp.unpad_and_resize_mask(logits, resize_hw, rgb.shape[:2])
            mask = binarize_logits(pred)
            from PIL import Image
            base = os.path.splitext(os.path.basename(image_path))[0]
            mask_path = os.path.join(args.vis_save_path,
                                     f"{base}_{turn}_mask.jpg")
            Image.fromarray((mask * 255).astype(np.uint8)).save(mask_path)
            overlay = rgb.copy()
            overlay[mask > 0] = (0.5 * overlay[mask > 0] +
                                 0.5 * np.array([255, 0, 0])).astype(np.uint8)
            ov_path = os.path.join(args.vis_save_path,
                                   f"{base}_{turn}_masked.jpg")
            Image.fromarray(overlay).save(ov_path)
            print(f"{mask_path} saved.")
            print(f"{ov_path} saved.")
        turn += 1


if __name__ == "__main__":
    main()
