"""MedPLIB composite model: CLIP -> projector -> splice -> (MoE-)LLaMA ->
<SEG> capture -> SAM-Med2D (medplib_tpu/models/medplib.py).

The port covers the pixel-grounding `generate` path with greedy decoding
(prefill into a bf16 or int8 KV cache, decode with the <SEG> hidden state
captured inside the loop, then one batched SAM encode + mask decode over
every SEG slot), over one image per row or several (the in-context
config: query + example images, each spliced at its own sentinel), and
the dense training forward `model_forward` (CE + mask losses, frozen CLIP
and SAM encoders, per-layer remat). Sampling, streaming, region inputs,
the ICL mask encoder and token compressor, and MoE training are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.models import (clip, llama, losses, moe_llama,
                                      projector, sam_med2d)
from medplib_tpu_torch.ops import splice as splice_ops
from medplib_tpu_torch.ops.initializers import dense_init

Params = Dict[str, Any]


class Batch(NamedTuple):
    """Static-shape batch: the fields of the JAX package's Batch that the
    generate and training paths read (the ICL mask-encoder and the region
    fields come with their slices). generate reads no mask field, so they
    may stay None there."""

    input_ids: torch.Tensor          # [B, T_in] with sentinel ids
    input_mask: torch.Tensor         # [B, T_in]
    labels: torch.Tensor             # [B, T_in]
    images_clip: torch.Tensor        # [B, MAX_IMG, S, S, 3]
    images_sam: torch.Tensor         # [B, S', S', 3]
    image_token_lengths: torch.Tensor  # [B, MAX_IMG]
    gt_masks: Optional[torch.Tensor] = None    # [B, MAX_SEG, Hm, Wm]
    mask_valid: Optional[torch.Tensor] = None  # [B, MAX_SEG] bool

    @staticmethod
    def make(input_ids, input_mask, labels, images_clip, images_sam,
             image_token_lengths, *, gt_masks=None, mask_valid=None,
             sam_frame=256) -> "Batch":
        """The JAX package's Batch.make: absent mask fields become one
        all-zero, invalid slot per row."""
        b, dev = input_ids.shape[0], input_ids.device
        if gt_masks is None:
            gt_masks = torch.zeros((b, 1, sam_frame, sam_frame), device=dev)
        if mask_valid is None:
            mask_valid = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        return Batch(input_ids, input_mask, labels, images_clip, images_sam,
                     image_token_lengths, gt_masks, mask_valid)


def init_medplib(gen: torch.Generator, cfg: MedplibConfig,
                 dtype=torch.float32, device="cuda") -> Params:
    h = cfg.llm.hidden_size
    if cfg.moe.enable:
        llm = moe_llama.init_moe_llama(gen, cfg.llm, cfg.moe, dtype,
                                       cfg.vocab_size_padded, device)
    else:
        llm = llama.init_llama(gen, cfg.llm, dtype, cfg.vocab_size_padded,
                               device)
    return {
        "llm": llm,
        "clip": clip.init_clip_vision(gen, cfg.vision, dtype, device),
        "mm_projector": projector.init_projector(gen, cfg.projector, dtype,
                                                 device),
        "region_fea_adapter": projector.init_region_adapter(
            gen, cfg.projector.mm_hidden_size, h, dtype, device),
        "sam": sam_med2d.init_sam(gen, cfg.sam, dtype, device),
        "text_hidden_fcs": {
            "fc1": {"kernel": dense_init(gen, h, h, dtype, device),
                    "bias": torch.zeros((h,), dtype=dtype, device=device)},
            "fc2": {"kernel": dense_init(gen, h, cfg.seg.out_dim, dtype,
                                         device),
                    "bias": torch.zeros((cfg.seg.out_dim,), dtype=dtype,
                                        device=device)},
        },
    }


def text_hidden_fcs(p: Params, hidden: torch.Tensor) -> torch.Tensor:
    x = torch.relu(hidden @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    return x @ p["fc2"]["kernel"] + p["fc2"]["bias"]


def encode_images(params: Params, cfg: MedplibConfig,
                  images_clip: torch.Tensor):
    """images_clip [B, MAX_IMG, S, S, 3] -> (feature buffer
    [B, MAX_IMG * L, H], L tokens per image; image i of a row at rows
    [i * L, (i + 1) * L)). The CLIP tower is frozen and runs without
    autograd (stop_gradient in the JAX package)."""
    if cfg.projector.token_compress or cfg.projector.mask_encoder:
        raise NotImplementedError("ICL token compression / mask encoder "
                                  "are not ported yet")
    b, n_img = images_clip.shape[:2]
    flat = images_clip.reshape((b * n_img,) + images_clip.shape[2:])
    with torch.no_grad():
        raw = clip.forward_features(params["clip"], flat, cfg.vision)
    proj = projector.apply_projector(params["mm_projector"], raw)
    l_img = proj.shape[1]
    return proj.reshape(b, n_img * l_img, -1), l_img


def splice_batch(params: Params, cfg: MedplibConfig, batch: Batch):
    """-> (embeds, labels_out, attn_mask, seg_mask, splice map)."""
    buffer, l_max = encode_images(params, cfg, batch.images_clip)
    n_img = batch.images_clip.shape[1]
    dev = batch.input_ids.device
    starts = (torch.arange(n_img, device=dev) * l_max)[None, :].expand(
        batch.image_token_lengths.shape)
    out_len = batch.input_ids.shape[1] + n_img * (l_max - 1)
    sm = splice_ops.compute_splice_map(
        batch.input_ids, batch.input_mask, batch.image_token_lengths,
        out_len=out_len, image_feat_starts=starts)
    token_embeds = llama.embed(params["llm"], batch.input_ids)
    embeds, labels_out, seg_mask = splice_ops.splice_embeddings(
        sm, batch.input_ids, token_embeds, buffer, labels=batch.labels,
        seg_token_idx=cfg.seg_token_idx)
    return embeds, labels_out, sm.attn_mask, seg_mask, sm


def _llm_forward(params, cfg: MedplibConfig, embeds, attn_mask, cache=None,
                 train=True, remat=False):
    if cfg.moe.enable:
        if train or remat:
            raise NotImplementedError("MoE training is not ported yet")
        return moe_llama.forward(params["llm"], cfg.llm, cfg.moe, embeds,
                                 attn_mask, cache=cache, train=False)
    return llama.forward(params["llm"], cfg.llm, embeds, attn_mask,
                         cache=cache, remat=remat)


def _llm_decode(params, cfg: MedplibConfig, embeds, cache):
    if cfg.moe.enable:
        return moe_llama.forward_decode(params["llm"], cfg.llm, cfg.moe,
                                        embeds, cache)
    return llama.forward_decode(params["llm"], cfg.llm, embeds, cache)


def decode_seg_masks(params: Params, cfg: MedplibConfig,
                     sam_embeddings: torch.Tensor, seg_embeds: torch.Tensor,
                     out_size: Optional[int] = None):
    """sam_embeddings [B, h, w, D]; seg_embeds [B, S, out_dim]
    -> (mask logits [B, S, out, out], iou [B, S]); out_size defaults to
    the SAM input size."""
    b, s, d = seg_embeds.shape
    sparse, dense = sam_med2d.encode_prompts(
        params["sam"]["prompt_encoder"], cfg.sam, b * s,
        text_embeds=seg_embeds.reshape(b * s, 1, d))
    img = sam_embeddings.repeat_interleave(s, dim=0)
    pe = sam_med2d.dense_pe(params["sam"]["prompt_encoder"], cfg.sam)
    low_res, iou = sam_med2d.decode_masks(
        params["sam"]["mask_decoder"], cfg.sam, img, pe, sparse, dense,
        multimask_output=False)
    out_size = out_size or cfg.sam.image_size
    masks = sam_med2d.postprocess_masks(low_res, out_size)
    return masks.reshape(b, s, out_size, out_size), iou.reshape(b, s)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def model_forward(params: Params, cfg: MedplibConfig, batch: Batch,
                  train: bool = True, seg_flag: bool = True,
                  remat: bool = True, max_segs: Optional[int] = None):
    """Teacher-forced forward -> dict of losses ("loss" is the total):
    shifted CE over the spliced labels, and with seg_flag the mask losses
    of every <SEG> slot decoded at gt_masks' size, valid where a SEG was
    found and mask_valid holds. With train=False it also returns
    pred_masks and seg_valid."""
    embeds, labels_out, attn_mask, seg_mask, _ = splice_batch(params, cfg,
                                                              batch)
    hidden, _, aux = _llm_forward(params, cfg, embeds, attn_mask,
                                  train=train, remat=remat)
    logits = llama.logits(params["llm"], hidden)
    ce = losses.cross_entropy_loss(logits, labels_out) * cfg.seg.ce_loss_weight
    if cfg.moe.enable:
        ce = ce + cfg.moe.router_aux_loss_coef * aux
    out = {"ce_loss": ce}
    if not seg_flag:
        zero = torch.zeros((), device=ce.device)
        out.update(loss=ce, mask_bce_loss=zero, mask_dice_loss=zero,
                   mask_loss=zero)
        return out

    with torch.no_grad():       # frozen encoder (stop_gradient in JAX)
        sam_emb = sam_med2d.encode_image(params["sam"]["image_encoder"],
                                         batch.images_sam, cfg.sam)
    s_max = max_segs or batch.gt_masks.shape[1]
    proj_hidden = text_hidden_fcs(params["text_hidden_fcs"], hidden)
    seg_embeds, seg_valid, _ = splice_ops.gather_seg_embeddings(
        proj_hidden, seg_mask, s_max)
    pred_masks, pred_iou = decode_seg_masks(params, cfg, sam_emb, seg_embeds,
                                            batch.gt_masks.shape[-1])

    valid = (seg_valid & batch.mask_valid.bool()).reshape(-1)
    pm = pred_masks.reshape((-1,) + pred_masks.shape[2:])
    gm = batch.gt_masks.reshape((-1,) + batch.gt_masks.shape[2:])
    bce = losses.sigmoid_ce_loss(pm, gm, valid)
    dice = losses.dice_loss(pm, gm, valid)
    iou_l = losses.mask_iou_loss(pm, gm, pred_iou.reshape(-1), valid)
    focal = losses.focal_loss(pm, gm, valid)
    sc = cfg.seg
    mask_loss = (sc.bce_loss_weight * bce + sc.dice_loss_weight * dice
                 + sc.iou_loss_weight * iou_l + sc.focal_loss_weight * focal)
    out.update(
        loss=ce + mask_loss,
        mask_bce_loss=sc.bce_loss_weight * bce,
        mask_dice_loss=sc.dice_loss_weight * dice,
        mask_loss=mask_loss,
        unscale_mask_bce_loss=bce, unscale_mask_dice_loss=dice,
        unscale_mask_iou_loss=iou_l, unscale_mask_focal_loss=focal,
    )
    if not train:
        out["pred_masks"] = pred_masks
        out["seg_valid"] = seg_valid
    return out


class GenerateResult(NamedTuple):
    output_ids: torch.Tensor     # [B, MAX_NEW] (0 after EOS)
    num_generated: torch.Tensor  # [B]
    pred_masks: torch.Tensor     # [B, S, out, out] mask logits per SEG slot
    seg_valid: torch.Tensor      # [B, S]
    has_seg: torch.Tensor        # [B] (slot 0 else holds the fallback)


def _seg_slot_write(seg_emb, seg_count, cap, is_seg):
    """Write cap [B, D] into seg_emb [B, S, D] at each row's next free slot
    where is_seg -> (seg_emb, seg_count)."""
    s = seg_emb.shape[1]
    can = is_seg & (seg_count < s)
    slot = (torch.arange(s, device=seg_emb.device)[None, :]
            == seg_count[:, None]) & can[:, None]
    seg_emb = torch.where(slot[..., None], cap[:, None, :].to(seg_emb.dtype),
                          seg_emb)
    return seg_emb, seg_count + can.to(seg_count.dtype)


@torch.no_grad()
def generate(params: Params, cfg: MedplibConfig, batch: Batch,
             max_new_tokens: int = 64, eos_id: int = 2,
             max_segs: int = 1, kv_quant: bool = False) -> GenerateResult:
    """Greedy decode + pixel grounding. SEG hidden states are captured
    inside the loop (prompt SEGs first, then generated ones, up to
    max_segs); a row with no SEG grounds the last step's projected hidden
    in slot 0. kv_quant: int8 KV cache with per-token-per-head scales."""
    b = batch.input_ids.shape[0]
    dev = batch.input_ids.device
    embeds, _, attn_mask, seg_mask_prompt, _ = splice_batch(params, cfg,
                                                            batch)
    cache = llama.KVCache.init(cfg.llm, b, embeds.shape[1] + max_new_tokens,
                               dtype=embeds.dtype, device=dev,
                               quant=kv_quant)
    hidden, cache, _ = _llm_forward(params, cfg, embeds, attn_mask, cache,
                                    train=False)
    last_idx = (attn_mask.sum(-1) - 1).clamp(min=0).long()
    last_hidden = torch.gather(
        hidden, 1, last_idx[:, None, None].expand(-1, 1, hidden.shape[-1]))
    fcs = params["text_hidden_fcs"]
    next_tok = torch.argmax(llama.logits(params["llm"], last_hidden)[:, 0],
                            dim=-1)

    p_emb, p_valid, _ = splice_ops.gather_seg_embeddings(
        text_hidden_fcs(fcs, hidden), seg_mask_prompt, max_segs)
    seg_emb = torch.where(p_valid[..., None], p_emb,
                          torch.zeros_like(p_emb)).to(embeds.dtype)
    seg_count = p_valid.sum(1).to(torch.int32)
    first_cap = text_hidden_fcs(fcs, last_hidden)[:, 0]
    seg_emb, seg_count = _seg_slot_write(seg_emb, seg_count, first_cap,
                                         next_tok == cfg.seg_token_idx)

    tok, done = next_tok, torch.zeros((b,), dtype=torch.bool, device=dev)
    last_cap = first_cap.to(seg_emb.dtype)
    toks, dones = [], []
    for _ in range(max_new_tokens):
        toks.append(tok)
        dones.append(done)
        emb = llama.embed(params["llm"], tok[:, None])
        hidden, cache = _llm_decode(params, cfg, emb, cache)
        new_tok = torch.argmax(llama.logits(params["llm"], hidden)[:, 0],
                               dim=-1)
        is_seg = (new_tok == cfg.seg_token_idx) & ~done
        cap = text_hidden_fcs(fcs, hidden)[:, 0]
        seg_emb, seg_count = _seg_slot_write(seg_emb, seg_count, cap, is_seg)
        last_cap = torch.where(done[:, None], last_cap,
                               cap.to(last_cap.dtype))
        new_tok = torch.where(done, torch.zeros_like(new_tok), new_tok)
        done = done | (new_tok == eos_id)
        tok = new_tok
    output_ids = torch.stack(toks, dim=1)
    num_generated = (~torch.stack(dones, dim=1)).sum(1)

    has_seg = seg_count > 0
    seg_emb[:, 0] = torch.where(has_seg[:, None], seg_emb[:, 0],
                                last_cap.to(seg_emb.dtype))
    seg_valid = (torch.arange(max_segs, device=dev)[None, :]
                 < seg_count[:, None])
    sam_emb = sam_med2d.encode_image(params["sam"]["image_encoder"],
                                     batch.images_sam, cfg.sam)
    pred, _ = decode_seg_masks(params, cfg, sam_emb, seg_emb)
    return GenerateResult(output_ids=output_ids, num_generated=num_generated,
                          pred_masks=pred, seg_valid=seg_valid,
                          has_seg=has_seg)
