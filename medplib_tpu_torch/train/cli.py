"""Training CLI (medplib_tpu/train/cli.py): the same flags and defaults,
plus --device. Tokenizer surgery, model build (dense or MoE), LoRA
injection, stage-4 expert seeding from donor checkpoints, the dataset and
collator (ICL with --icl-enable), the prefetching loader, and training
with auto-resume and per-epoch validation (--val-data-path), or one
validation pass of the newest checkpoint (--eval-only).

Usage (stage-4 style MoE SFT on the card):
  python -m medplib_tpu_torch.train.cli \\
    --version <HF export dir, a save_params file, or random> \\
    --tokenizer <tokenizer dir> --moe-enable \\
    --expert-pretrained-path <stage-3 dir>,<stage-2 dir> \\
    --dataset-json data/train.json --image-folder data/images \\
    --val-data-path data/val.json --exp-name stage4 --batch-size 4 \\
    --grad-accumulation-steps 8
A CPU debug run: add --tiny --version random --device cpu.

Several processes (parallel/mesh.py): every process runs this CLI with
the same --coordinator host:port (rank 0 listens there), the same
--num-processes and its own --process-id; --mesh-data / --mesh-expert /
--mesh-model lay the processes out (their product is the process count;
--mesh-expert > 1 trains the MoE expert-parallel). Each process loads its
own rows of every global batch (--batch-size and --val-batch-size are
global), trains its shards, and rank 0 writes the consolidated
checkpoint. NCCL on CUDA devices (one per process), gloo on the CPU:
  python -m medplib_tpu_torch.train.cli ... --coordinator localhost:29500 \
    --num-processes 2 --process-id 0 --mesh-data 2     (and --process-id 1)
"""

from __future__ import annotations

import argparse
import os


def build_argparser():
    ap = argparse.ArgumentParser(description="MedPLIB trainer (PyTorch)")
    # model
    ap.add_argument("--version", required=True,
                    help="params source: HF export dir, a save_params file, "
                         "or 'random'")
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--vision-pretrained", default=None,
                    help="sam-med2d_b.pth")
    ap.add_argument("--clip-dir", default=None)
    ap.add_argument("--moe-enable", action="store_true")
    ap.add_argument("--num-experts", type=int, default=2)
    ap.add_argument("--top-k-experts", type=int, default=1)
    ap.add_argument("--capacity-factor", type=float, default=1.5)
    ap.add_argument("--eval-capacity-factor", type=float, default=2.0)
    ap.add_argument("--min-capacity", type=int, default=0)
    ap.add_argument("--moe-mode", default="dense")
    ap.add_argument("--moe-layers-idx", default=None,
                    help="comma-separated custom MoE layer indices "
                         "(overrides --moe-mode)")
    ap.add_argument("--use-residual", action="store_true",
                    help="Residual-MoE: dense MLP in parallel with experts, "
                         "learned 2-way mix")
    ap.add_argument("--router-aux-loss-coef", type=float, default=0.01)
    ap.add_argument("--expert-pretrained-path", default=None,
                    help="comma-separated donor checkpoint dirs (stage 4)")
    # losses
    ap.add_argument("--ce-loss-weight", type=float, default=1.0)
    ap.add_argument("--bce-loss-weight", type=float, default=2.0)
    ap.add_argument("--dice-loss-weight", type=float, default=0.5)
    ap.add_argument("--focal-loss-weight", type=float, default=0.0)
    ap.add_argument("--iou-loss-weight", type=float, default=0.0)
    ap.add_argument("--no-seg", action="store_true")
    ap.add_argument("--region-fea-adapter", action="store_true")
    ap.add_argument("--region-geo-sampler", action="store_true")
    # data
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--image-folder", required=True)
    ap.add_argument("--conv-template", default="llava_v1")
    ap.add_argument("--model-max-length", type=int, default=1024)
    # ICL stage
    ap.add_argument("--icl-enable", action="store_true")
    ap.add_argument("--icl-mask-mode", default="overlay",
                    choices=["overlay", "separate"])
    ap.add_argument("--icl-mask-encoder", action="store_true")
    ap.add_argument("--mask-encoder-token-count", type=int, default=None)
    ap.add_argument("--mm-token-compress", action="store_true")
    ap.add_argument("--mm-compressed-token-count", type=int, default=None)
    ap.add_argument("--max-icl-examples", type=int, default=3)
    # validation
    ap.add_argument("--val-data-path", default=None)
    ap.add_argument("--val-batch-size", type=int, default=None)
    ap.add_argument("--no-eval", action="store_true",
                    help="skip the per-epoch validation pass even when "
                         "--val-data-path is set")
    ap.add_argument("--eval-only", action="store_true",
                    help="restore the newest checkpoint and run one "
                         "validation pass, no training")
    # optimization
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--grad-accumulation-steps", type=int, default=1)
    # loader thread pool; 0 = synchronous in-thread loading
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--lora-r", type=int, default=8)
    ap.add_argument("--lora-alpha", type=int, default=16)
    ap.add_argument("--lora-dropout", type=float, default=0.05,
                    help="dropout on the LoRA adapter input during training")
    ap.add_argument("--lora-target-modules", default="q_proj,v_proj")
    ap.add_argument("--no-lora", action="store_true")
    ap.add_argument("--sft-modules",
                    default="text_hidden_fcs,mask_decoder,lm_head,"
                            "embed_tokens,region_fea_adapter",
                    help="modules kept fully trainable alongside LoRA; "
                         "empty string trains only LoRA adapters")
    ap.add_argument("--no-train-mask-decoder", action="store_true",
                    help="freeze the SAM mask decoder")
    ap.add_argument("--save-steps", type=int, default=500)
    ap.add_argument("--log-steps", type=int, default=10)
    ap.add_argument("--exp-name", default="medplib-tpu")
    ap.add_argument("--log-base-dir", default="./runs")
    ap.add_argument("--auto-resume", action="store_true", default=True)
    # mesh and multi-process flags of the JAX trainer (sizes > 1 raise)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-expert", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0; enables multihost")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    # debug
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model config for CPU smoke / debug runs; "
                         "--version random initializes random params")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and batches (cuda, cpu)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    n_mesh = args.mesh_data * args.mesh_expert * args.mesh_model
    if args.num_processes > 1 and not args.coordinator:
        raise ValueError("--num-processes > 1 needs --coordinator")
    if n_mesh != args.num_processes:
        raise ValueError(f"the mesh ({args.mesh_data}, {args.mesh_expert}, "
                         f"{args.mesh_model}) needs {n_mesh} processes, "
                         f"--num-processes is {args.num_processes}")
    import contextlib

    import numpy as np
    import torch
    from transformers import AutoTokenizer

    from medplib_tpu_torch.config import (MedplibConfig, MeshConfig,
                                          MoeConfig, ProjectorConfig,
                                          SegConfig, TrainConfig)
    from medplib_tpu_torch.data import tokenize as tk
    from medplib_tpu_torch.data.dataset import (CollatorConfig, DataConfig,
                                                LazySupervisedDataset,
                                                collate, to_model_batch)
    from medplib_tpu_torch.data.loader import PrefetchLoader
    from medplib_tpu_torch.models.medplib import image_tokens_per_image
    from medplib_tpu_torch.parallel import mesh as mesh_lib
    from medplib_tpu_torch.train import lora as lora_lib
    from medplib_tpu_torch.train.trainer import Trainer

    device = torch.device(args.device)
    mesh = None
    if args.coordinator:
        device = mesh_lib.init_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device=args.device)
        mesh = mesh_lib.make_mesh(MeshConfig(args.mesh_data,
                                             args.mesh_expert,
                                             args.mesh_model))
    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    tk.add_special_tokens(tokenizer)
    seg_idx = tokenizer.convert_tokens_to_ids("<SEG>")

    moe_cfg = MoeConfig(
        enable=args.moe_enable, num_experts=args.num_experts,
        top_k=args.top_k_experts, capacity_factor=args.capacity_factor,
        eval_capacity_factor=args.eval_capacity_factor,
        min_capacity=args.min_capacity, moe_mode=args.moe_mode,
        moe_layers_idx=(tuple(int(i) for i in args.moe_layers_idx.split(","))
                        if args.moe_layers_idx else None),
        use_residual=args.use_residual,
        router_aux_loss_coef=args.router_aux_loss_coef)
    seg_cfg = SegConfig(
        enable=not args.no_seg, ce_loss_weight=args.ce_loss_weight,
        bce_loss_weight=args.bce_loss_weight,
        dice_loss_weight=args.dice_loss_weight,
        focal_loss_weight=args.focal_loss_weight,
        iou_loss_weight=args.iou_loss_weight,
        train_mask_decoder=not args.no_train_mask_decoder)
    if args.tiny:
        from medplib_tpu_torch.config import tiny_cli_config
        cfg = tiny_cli_config(moe_cfg, seg_idx, len(tokenizer),
                              seg_cfg=seg_cfg,
                              region_adapter=args.region_fea_adapter,
                              region_geo_sampler=args.region_geo_sampler)
    else:
        cfg = MedplibConfig(
            moe=moe_cfg, seg=seg_cfg,
            projector=ProjectorConfig(
                region_adapter=args.region_fea_adapter,
                region_geo_sampler=args.region_geo_sampler),
            seg_token_idx=seg_idx, vocab_size_padded=len(tokenizer))
    if args.icl_enable:
        from medplib_tpu_torch.config import with_icl
        cfg = with_icl(
            cfg, token_compress=args.mm_token_compress,
            compress_tokens=args.mm_compressed_token_count,
            mask_encoder=(args.icl_mask_encoder and
                          args.icl_mask_mode == "separate"),
            mask_encoder_tokens=args.mask_encoder_token_count,
            max_icl_examples=args.max_icl_examples)

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    params = _load_params(args, cfg, dtype, device)
    if not args.no_lora:
        params["llm"] = lora_lib.inject(
            torch.Generator(device=device).manual_seed(0), params["llm"],
            tuple(args.lora_target_modules.split(",")), args.lora_r)
    if mesh is not None:
        params = mesh_lib.shard_params(mesh, params)
    # this process's rows of each global batch
    shard = ((mesh.index(mesh_lib.ROWS), mesh.size(mesh_lib.ROWS))
             if mesh is not None else (0, 1))

    tcfg = TrainConfig(
        lr=args.lr, warmup_steps=args.warmup_steps,
        total_steps=args.epochs * args.steps_per_epoch,
        batch_size=args.batch_size,
        grad_accumulation_steps=args.grad_accumulation_steps,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        lora_enable=not args.no_lora, lora_r=args.lora_r,
        lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout,
        lora_target_modules=tuple(args.lora_target_modules.split(",")),
        sft_modules=tuple(m for m in args.sft_modules.split(",") if m),
        save_steps=args.save_steps, log_steps=args.log_steps,
        max_seq_len=args.model_max_length)

    def make_dataset(json_path, train=True):
        dcfg = DataConfig(data_path=json_path, image_folder=args.image_folder,
                          conv_template=args.conv_template,
                          sam_image_size=cfg.sam.image_size,
                          clip_image_size=cfg.vision.image_size,
                          clip_patch=cfg.vision.patch_size)
        if args.icl_enable:
            from medplib_tpu_torch.data.icl_dataset import \
                ICLLazySupervisedDataset
            return ICLLazySupervisedDataset(
                dcfg, tokenizer, train=train, mask_mode=args.icl_mask_mode,
                use_mask_encoder=cfg.projector.mask_encoder,
                image_tokens=image_tokens_per_image(cfg),
                mask_tokens=cfg.projector.mask_encoder_tokens,
                max_examples=cfg.max_icl_examples,
                mask_input_size=cfg.projector.mask_input_size)
        return LazySupervisedDataset(dcfg, tokenizer, train=train)

    collate_fn = None
    if args.icl_enable:
        from functools import partial

        from medplib_tpu_torch.data.icl_dataset import collate_icl
        max_slots = (cfg.max_icl_examples * 2 + 1
                     if args.icl_mask_mode == "separate"
                     else cfg.max_icl_examples + 1)
        collate_fn = partial(collate_icl, max_slots=max_slots,
                             mask_tokens=cfg.projector.mask_encoder_tokens)

    dataset = make_dataset(args.dataset_json, train=True)
    cc = CollatorConfig(
        max_seq_len=args.model_max_length,
        image_tokens=cfg.vision.num_patches,
        sam_image_size=cfg.sam.image_size,
        clip_image_size=cfg.vision.image_size,
        pad_token_id=tokenizer.pad_token_id or 0)

    def batch_iterator():
        return iter(PrefetchLoader(
            dataset, cc, batch_size=args.batch_size,
            accum_steps=args.grad_accumulation_steps,
            num_workers=args.workers, seed=42, collate_fn=collate_fn,
            device=device, shard=shard))

    # per-epoch validation: one in-order pass; the last partial batch is
    # padded to the static shape with its padding rows' mask_valid cleared
    val_batches_fn = None
    if args.val_data_path and not args.no_eval:
        val_dataset = make_dataset(args.val_data_path, train=False)
        vb = args.val_batch_size or args.batch_size
        vcollate = collate_fn or collate

        if vb % shard[1]:
            raise ValueError(f"validation batch {vb} does not split over "
                             f"{shard[1]} row shards")
        rows = slice(shard[0] * vb // shard[1],
                     (shard[0] + 1) * vb // shard[1])

        def val_batches_fn():
            n = len(val_dataset)
            for start in range(0, n, vb):
                idx = list(range(start, min(start + vb, n)))
                n_real = len(idx)
                idx += [idx[-1]] * (vb - n_real)
                real = [j < n_real for j in range(vb)][rows]
                arrays, _ = vcollate([val_dataset[i] for i in idx[rows]], cc)
                arrays["mask_valid"][~np.asarray(real)] = False
                yield to_model_batch(arrays, device)

    log_dir = os.path.join(args.log_base_dir, args.exp_name)
    with (mesh_lib.set_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        trainer = Trainer(cfg, tcfg, params, log_dir,
                          seg_flag=not args.no_seg,
                          rp_flag=args.region_fea_adapter
                          or args.region_geo_sampler,
                          ep_shard=args.mesh_expert > 1)
        if args.eval_only:
            if val_batches_fn is None:
                raise SystemExit("--eval-only needs --val-data-path "
                                 "(and not --no-eval)")
            step = trainer.resume_if_possible()
            vres = trainer.validate(val_batches_fn())
            print(f"eval_only @ step {step}: "
                  f"giou={vres['giou']:.4f} ciou={vres['ciou']:.4f} "
                  f"dice={vres['dice']:.4f} loss={vres['loss']:.4f}")
            return vres
        final = trainer.fit(batch_iterator, val_batches_fn=val_batches_fn)
    print(f"training done at step {final}; checkpoints in {log_dir}")
    return final


def _load_params(args, cfg, dtype, device):
    """The tree named by --version: 'random' is a seeded init, as it
    stands; a directory of HF shards is the released layout merged over a
    seeded init; anything else a save_params file. The last two get their
    experts from the donors of --expert-pretrained-path and are cast to
    `dtype`."""
    import torch

    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils.checkpoint import load_params
    from medplib_tpu_torch.utils.export import load_reference_checkpoint
    from medplib_tpu_torch.utils.hf_weights import cast_tree

    def init():
        return medplib.init_medplib(
            torch.Generator(device=device).manual_seed(0), cfg, dtype, device)

    if args.version == "random":
        return init()
    if os.path.isdir(args.version) and (
            os.path.exists(os.path.join(args.version, "config.json"))
            or any(f.endswith((".bin", ".safetensors"))
                   for f in os.listdir(args.version))):
        _, loaded = load_reference_checkpoint(
            args.version, args.vision_pretrained, args.clip_dir,
            moe=args.moe_enable, num_experts=args.num_experts, device=device)
        params = init()
        params.update(loaded)
        for tower, flag in (("clip", "--clip-dir"),
                            ("sam", "--vision-pretrained")):
            if tower not in loaded:
                print(f"WARNING: no {tower!r} weights in {args.version}; "
                      f"the {tower} tower is RANDOMLY initialized - pass "
                      f"{flag} to load real weights", flush=True)
    else:
        params = load_params(args.version, device=device)

    if args.expert_pretrained_path and cfg.moe.enable:
        params = _seed_experts_from_donors(args, cfg, params, device)
    return cast_tree(params, dtype)


def _seed_experts_from_donors(args, cfg, params, device="cuda"):
    """Stage-4 expert surgery: expert e from donor checkpoint e's dense
    MLP; donor 0 (the stage-3 seg specialist) also supplies
    text_hidden_fcs and the SAM mask decoder, donor 1 (stage-2 VQA) the
    region adapter. A Residual-MoE tree's dense copy is re-seeded from the
    tree's own dense MLP."""
    from medplib_tpu_torch.models.moe_llama import build_experts_from_donors
    from medplib_tpu_torch.utils import hf_weights as hw
    from medplib_tpu_torch.utils.export import load_hf_torch_dir

    donor_mlps = []
    for idx, path in enumerate(args.expert_pretrained_path.split(",")):
        sd = load_hf_torch_dir(path, device)
        donor_mlps.append(hw.llama_from_hf(sd, cfg.llm)["layers"]["mlp"])
        if idx == 0:
            if "model.text_hidden_fcs.0.0.weight" in sd:
                params["text_hidden_fcs"] = {
                    "fc1": hw._linear(sd, "model.text_hidden_fcs.0.0"),
                    "fc2": hw._linear(sd, "model.text_hidden_fcs.0.2")}
            pre = "model.visual_model."
            dec = {k[len(pre):]: v for k, v in sd.items()
                   if k.startswith(pre + "mask_decoder")}
            if dec:
                params["sam"]["mask_decoder"] = hw._sam_mask_decoder(
                    dec, cfg.sam)
        elif "model.region_fea_adapter.weight" in sd:
            params["region_fea_adapter"] = hw._linear(
                sd, "model.region_fea_adapter")
        del sd
    moe = params["llm"]["layers"]["moe"]
    moe["experts"] = build_experts_from_donors(donor_mlps)
    if cfg.moe.use_residual and "residual_mlp" in moe:
        moe["residual_mlp"] = {
            n: {k: v.clone() for k, v in node.items()}
            for n, node in params["llm"]["layers"]["mlp"].items()}
    return params


if __name__ == "__main__":
    main()
