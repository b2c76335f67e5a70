"""Typed model configuration, the port's copy of medplib_tpu/config.py.

The classes carry the same names, fields and defaults as the JAX package's
(tests/test_torch_modules.py holds them equal), but live here so that the
port, and the GPU machine that runs it, never import the JAX package.
`flagship_cfg` is the counterpart of __graft_entry__._flagship_cfg, and
`with_icl` of the JAX package's config.with_icl.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
REGION_TOKEN_INDEX = -300


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False


@dataclass(frozen=True)
class MoeConfig:
    enable: bool = False
    num_experts: int = 2
    top_k: int = 1
    capacity_factor: float = 1.5
    eval_capacity_factor: float = 2.0
    min_capacity: int = 0
    use_residual: bool = False
    router_aux_loss_coef: float = 0.01
    moe_mode: str = "dense"
    moe_layers_idx: Optional[Tuple[int, ...]] = None

    def layer_indices(self, num_layers: int) -> Tuple[int, ...]:
        """Which decoder layers get an MoE MLP."""
        if not self.enable:
            return ()
        if self.moe_layers_idx is not None:
            return tuple(self.moe_layers_idx)
        mode = self.moe_mode
        if mode == "dense":
            return tuple(range(num_layers))
        if mode == "first_half":
            return tuple(range(0, num_layers // 2))
        if mode == "second_half":
            return tuple(range(num_layers // 2, num_layers))
        if mode == "sparse":
            return tuple(range(0, num_layers, 2))
        raise ValueError(f"unknown moe_mode {mode!r}")


@dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    select_layer: int = -2
    select_feature: str = "patch"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class SamConfig:
    image_size: int = 256
    patch_size: int = 16
    encoder_embed_dim: int = 768
    encoder_depth: int = 12
    encoder_num_heads: int = 12
    encoder_global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    use_rel_pos: bool = True
    use_adapter: bool = True
    adapter_ratio: float = 0.25
    mlp_ratio: float = 4.0
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_mlp_dim: int = 2048
    decoder_num_heads: int = 8
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class ProjectorConfig:
    projector_type: str = "mlp2x_gelu"
    mm_hidden_size: int = 1024
    hidden_size: int = 4096
    token_compress: bool = False
    compress_tokens: int = 256
    mask_encoder: bool = False
    mask_encoder_tokens: int = 64
    mask_input_size: int = 336
    region_adapter: bool = False
    region_geo_sampler: bool = False
    sampler_pooler_mode: str = "max"


@dataclass(frozen=True)
class SegConfig:
    enable: bool = True
    out_dim: int = 256
    train_mask_decoder: bool = True
    ce_loss_weight: float = 1.0
    bce_loss_weight: float = 2.0
    dice_loss_weight: float = 0.5
    focal_loss_weight: float = 0.0
    iou_loss_weight: float = 0.0


@dataclass(frozen=True)
class MedplibConfig:
    llm: LlamaConfig = field(default_factory=LlamaConfig)
    vision: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    sam: SamConfig = field(default_factory=SamConfig)
    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    moe: MoeConfig = field(default_factory=MoeConfig)
    seg: SegConfig = field(default_factory=SegConfig)
    seg_token_idx: int = 32000
    vocab_size_padded: int = 32320
    icl_enable: bool = False
    max_icl_examples: int = 3


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the stage-3 recipe's defaults)."""

    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.0
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.0
    batch_size: int = 4
    grad_accumulation_steps: int = 1
    epochs: int = 1
    steps_per_epoch: int = 500
    precision: str = "bf16"
    seed: int = 42
    # LoRA
    lora_enable: bool = True
    lora_r: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.05
    lora_target_modules: Tuple[str, ...] = ("q_proj", "v_proj")
    # modules whose full weights stay trainable alongside LoRA
    sft_modules: Tuple[str, ...] = (
        "text_hidden_fcs", "mask_decoder", "lm_head", "embed_tokens",
        "region_fea_adapter",
    )
    save_steps: int = 500
    log_steps: int = 10
    # sequence budget (model_max_length)
    max_seq_len: int = 1024


def flagship_cfg(num_layers: int = 32, moe: bool = True) -> MedplibConfig:
    """MedPLIB-7b-2e: 32-layer LLaMA-7B, with moe=True 2 experts on every
    layer, top-1 routing, capacity 1.5 / eval 2.0; CLIP ViT-L/14-336;
    SAM-Med2D ViT-B @256. Equal to __graft_entry__._flagship_cfg."""
    moe_cfg = (MoeConfig(enable=True, num_experts=2, top_k=1,
                         capacity_factor=1.5, eval_capacity_factor=2.0,
                         moe_mode="dense") if moe else MoeConfig())
    return MedplibConfig(llm=LlamaConfig(num_layers=num_layers), moe=moe_cfg,
                         seg=SegConfig(), seg_token_idx=32000,
                         vocab_size_padded=32320)


def with_icl(cfg: MedplibConfig, *, token_compress: bool = False,
             compress_tokens: Optional[int] = None,
             mask_encoder: bool = False,
             mask_encoder_tokens: Optional[int] = None,
             max_icl_examples: int = 3) -> MedplibConfig:
    """The ICL flags on a model config (the reference's --icl_enable,
    --mm_token_compress, --mm_compressed_token_count, --icl_mask_encoder,
    --mask_encoder_token_count). Configs with a CLIP input below 100
    pixels get proportionally small ICL sizes."""
    tiny = cfg.vision.image_size < 100
    if compress_tokens is None:
        compress_tokens = (max(cfg.vision.num_patches // 2, 1) if tiny
                           else cfg.projector.compress_tokens)
    if mask_encoder_tokens is None:
        mask_encoder_tokens = 4 if tiny else cfg.projector.mask_encoder_tokens
    proj = dataclasses.replace(
        cfg.projector, token_compress=bool(token_compress),
        compress_tokens=compress_tokens, mask_encoder=bool(mask_encoder),
        mask_encoder_tokens=mask_encoder_tokens,
        mask_input_size=(cfg.vision.image_size if tiny
                         else cfg.projector.mask_input_size))
    return dataclasses.replace(cfg, projector=proj, icl_enable=True,
                               max_icl_examples=max_icl_examples)
