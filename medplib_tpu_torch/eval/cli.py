"""Evaluation CLI (medplib_tpu/eval/cli.py): the same flags and defaults,
plus --device. Chunked data-parallel inference over a test JSON, VQA or
pixel-grounding mode (ICL with --icl-enable), answers jsonl + metrics.

  python -m medplib_tpu_torch.eval.cli --version <save_params file> \\
    --tokenizer <tokenizer dir> --dataset-json test.json \\
    --image-folder images --mode seg --moe-enable
A CPU debug run: --tiny --version random --device cpu.

--version is 'random' (the port's seeded init) or one file written by
medplib_tpu_torch.utils.checkpoint.save_params (a torch.save tree). An
orbax directory of the JAX package needs JAX to read and is not accepted;
a released checkpoint loads through utils/export.load_reference_checkpoint
and can be saved with save_params.
"""

from __future__ import annotations

import argparse
import json


def build_argparser():
    ap = argparse.ArgumentParser(description="MedPLIB eval (PyTorch)")
    ap.add_argument("--version", required=True,
                    help="'random' (seeded init) or a file written by "
                         "medplib_tpu_torch.utils.checkpoint.save_params "
                         "(one torch.save tree; not an orbax directory)")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--image-folder", required=True)
    ap.add_argument("--mode", default="vqa", choices=["vqa", "seg"])
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--model-max-length", type=int, default=512)
    ap.add_argument("--moe-enable", action="store_true")
    ap.add_argument("--num-experts", type=int, default=2)
    ap.add_argument("--conv-template", default="v1")
    ap.add_argument("--answers-file", default="answers.jsonl")
    ap.add_argument("--vis-mask", action="store_true")
    ap.add_argument("--vis-save-path", default="./vis_output")
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--metrics-file", default=None)
    # ICL: the ICL dataset and collator
    ap.add_argument("--icl-enable", action="store_true")
    ap.add_argument("--icl-mask-mode", default="overlay",
                    choices=["overlay", "separate"])
    ap.add_argument("--icl-mask-encoder", action="store_true")
    ap.add_argument("--mask-encoder-token-count", type=int, default=None)
    ap.add_argument("--mm-token-compress", action="store_true")
    ap.add_argument("--mm-compressed-token-count", type=int, default=None)
    ap.add_argument("--max-icl-examples", type=int, default=3)
    # debug
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model config for CPU smoke/debug; "
                         "--version random initializes random params")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and batches (cuda, cpu)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch
    from transformers import AutoTokenizer

    from medplib_tpu_torch.config import MedplibConfig, MoeConfig
    from medplib_tpu_torch.data import tokenize as tk
    from medplib_tpu_torch.data.dataset import (CollatorConfig, DataConfig,
                                                LazySupervisedDataset)
    from medplib_tpu_torch.eval.infer import EvalConfig, Evaluator
    from medplib_tpu_torch.utils.checkpoint import load_params
    from medplib_tpu_torch.utils.hf_weights import cast_tree

    device = torch.device(args.device)
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    tk.add_special_tokens(tokenizer)
    moe_cfg = MoeConfig(enable=args.moe_enable, num_experts=args.num_experts,
                        top_k=1, capacity_factor=1.5,
                        eval_capacity_factor=2.0, moe_mode="dense")
    seg_idx = tokenizer.convert_tokens_to_ids("<SEG>")
    if args.tiny:
        from medplib_tpu_torch.config import tiny_cli_config
        cfg = tiny_cli_config(moe_cfg, seg_idx, len(tokenizer))
    else:
        cfg = MedplibConfig(moe=moe_cfg, seg_token_idx=seg_idx,
                            vocab_size_padded=len(tokenizer))
    if args.icl_enable:
        from medplib_tpu_torch.config import with_icl
        cfg = with_icl(
            cfg, token_compress=args.mm_token_compress,
            compress_tokens=args.mm_compressed_token_count,
            mask_encoder=(args.icl_mask_encoder and
                          args.icl_mask_mode == "separate"),
            mask_encoder_tokens=args.mask_encoder_token_count,
            max_icl_examples=args.max_icl_examples)
    if args.version == "random":
        from medplib_tpu_torch.models import medplib
        params = medplib.init_medplib(
            torch.Generator(device=device).manual_seed(0), cfg,
            torch.float32, device)
    else:
        params = load_params(args.version, device=device)
    if args.precision == "bf16":
        params = cast_tree(params, torch.bfloat16)

    dcfg = DataConfig(data_path=args.dataset_json,
                      image_folder=args.image_folder,
                      conv_template=args.conv_template, augment_regions=False,
                      sam_image_size=cfg.sam.image_size,
                      clip_image_size=cfg.vision.image_size,
                      clip_patch=cfg.vision.patch_size)
    collate_fn = None
    if args.icl_enable:
        from functools import partial

        from medplib_tpu_torch.data.icl_dataset import (
            ICLLazySupervisedDataset, collate_icl)
        from medplib_tpu_torch.models.medplib import image_tokens_per_image
        dataset = ICLLazySupervisedDataset(
            dcfg, tokenizer, train=False, mask_mode=args.icl_mask_mode,
            use_mask_encoder=cfg.projector.mask_encoder,
            image_tokens=image_tokens_per_image(cfg),
            mask_tokens=cfg.projector.mask_encoder_tokens,
            max_examples=cfg.max_icl_examples,
            mask_input_size=cfg.projector.mask_input_size)
        max_slots = (cfg.max_icl_examples * 2 + 1
                     if args.icl_mask_mode == "separate"
                     else cfg.max_icl_examples + 1)
        collate_fn = partial(collate_icl, max_slots=max_slots,
                             mask_tokens=cfg.projector.mask_encoder_tokens)
    else:
        dataset = LazySupervisedDataset(dcfg, tokenizer, train=False)
    ecfg = EvalConfig(
        num_chunks=args.num_chunks, chunk_idx=args.chunk_idx,
        batch_size=args.batch_size, max_new_tokens=args.max_new_tokens,
        output_path=args.answers_file,
        vis_dir=args.vis_save_path if args.vis_mask else None)
    cc = CollatorConfig(
        max_seq_len=args.model_max_length,
        image_tokens=cfg.vision.num_patches,
        sam_image_size=cfg.sam.image_size,
        clip_image_size=cfg.vision.image_size,
        pad_token_id=tokenizer.pad_token_id or 0)
    evaluator = Evaluator(cfg, params, tokenizer, ecfg, cc,
                          collate_fn=collate_fn, device=device)
    metrics = evaluator.run(dataset, mode=args.mode)
    print(json.dumps(metrics, indent=2, default=str))
    if args.metrics_file:
        with open(args.metrics_file, "w") as f:
            json.dump(metrics, f, default=str)
    return metrics


if __name__ == "__main__":
    main()
