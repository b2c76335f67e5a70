"""MedPLIB composite model: CLIP -> projector -> splice -> (MoE-)LLaMA ->
<SEG> capture -> SAM-Med2D (medplib_tpu/models/medplib.py).

The port covers `generate` (prefill into a bf16 or int8 KV cache, decode
with greedy or temperature / top-p sampling from per-row seeded streams,
the <SEG> hidden state captured inside the loop, then one batched SAM
encode + mask decode over every SEG slot, or none with ground=False) over
one image per row or several (the in-context config: query + example
images or example masks through the mask encoder, each spliced at its own
sentinel, optionally through the 576 -> 256 token compressor), with region
inputs (rp_flag: the region adapter + closed-form pooling, or the geo
sampler), and the dense training forward `model_forward` (CE + mask
losses, frozen CLIP and SAM encoders, per-layer remat). Streaming and MoE
training are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.models import (clip, geo_sampler, llama, losses,
                                      moe_llama, projector, sam_med2d)
from medplib_tpu_torch.ops import sampling
from medplib_tpu_torch.ops import splice as splice_ops
from medplib_tpu_torch.ops.initializers import dense_init

Params = Dict[str, Any]


class Batch(NamedTuple):
    """Static-shape batch with the JAX package's Batch fields, in its
    order. Fields a path does not read may stay None (generate reads no
    mask field; the ICL fields are read only with the mask encoder, the
    region fields only with rp_flag); Batch.make fills every one."""

    input_ids: torch.Tensor          # [B, T_in] with sentinel ids
    input_mask: torch.Tensor         # [B, T_in]
    labels: torch.Tensor             # [B, T_in]
    images_clip: torch.Tensor        # [B, MAX_IMG, S, S, 3]
    images_sam: torch.Tensor         # [B, S', S', 3]
    image_token_lengths: torch.Tensor  # [B, MAX_IMG]
    image_is_mask: Optional[torch.Tensor] = None  # [B, MAX_IMG] ICL masks
    mask_images: Optional[torch.Tensor] = None    # [B, MAX_IMG, Sm, Sm]
    region_masks: Optional[torch.Tensor] = None   # [B, MAX_REG, 24, 24]
    region_valid: Optional[torch.Tensor] = None   # [B, MAX_REG] bool
    gt_masks: Optional[torch.Tensor] = None    # [B, MAX_SEG, Hm, Wm]
    mask_valid: Optional[torch.Tensor] = None  # [B, MAX_SEG] bool

    @staticmethod
    def make(input_ids, input_mask, labels, images_clip, images_sam,
             image_token_lengths, *, image_is_mask=None, mask_images=None,
             region_masks=None, region_valid=None, gt_masks=None,
             mask_valid=None, mask_size=256, sam_frame=256) -> "Batch":
        """The JAX package's Batch.make: absent fields become zeros (no
        mask slot, blank mask images, one invalid region of 24 x 24, one
        invalid all-zero ground-truth mask per row)."""
        b, dev = input_ids.shape[0], input_ids.device
        max_img = image_token_lengths.shape[1]

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return Batch(
            input_ids, input_mask, labels, images_clip, images_sam,
            image_token_lengths,
            image_is_mask=(image_is_mask if image_is_mask is not None
                           else z((b, max_img), torch.int32)),
            mask_images=(mask_images if mask_images is not None
                         else z((b, max_img, mask_size, mask_size))),
            region_masks=(region_masks if region_masks is not None
                          else z((b, 1, 24, 24))),
            region_valid=(region_valid if region_valid is not None
                          else z((b, 1), torch.bool)),
            gt_masks=(gt_masks if gt_masks is not None
                      else z((b, 1, sam_frame, sam_frame))),
            mask_valid=(mask_valid if mask_valid is not None
                        else z((b, 1), torch.bool)))


def init_medplib(gen: torch.Generator, cfg: MedplibConfig,
                 dtype=torch.float32, device="cuda") -> Params:
    h = cfg.llm.hidden_size
    if cfg.moe.enable:
        llm = moe_llama.init_moe_llama(gen, cfg.llm, cfg.moe, dtype,
                                       cfg.vocab_size_padded, device)
    else:
        llm = llama.init_llama(gen, cfg.llm, dtype, cfg.vocab_size_padded,
                               device)
    params = {
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
    pc = cfg.projector
    if pc.token_compress:
        params["mm_token_compressor"] = projector.init_token_compressor(
            gen, h, dtype, device)
    if pc.mask_encoder:
        params["mask_encoder"] = projector.init_mask_encoder(gen, h, dtype,
                                                             device)
    if pc.region_geo_sampler:
        params["region_geo_sampler"] = geo_sampler.init_geo_sampler(
            gen, pc.mm_hidden_size, h, dtype=dtype, device=device)
    return params


def text_hidden_fcs(p: Params, hidden: torch.Tensor) -> torch.Tensor:
    x = torch.relu(hidden @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    return x @ p["fc2"]["kernel"] + p["fc2"]["bias"]


def image_tokens_per_image(cfg: MedplibConfig) -> int:
    if cfg.projector.token_compress:
        return cfg.projector.compress_tokens
    return cfg.vision.num_patches


def encode_images(params: Params, cfg: MedplibConfig,
                  images_clip: torch.Tensor,
                  image_is_mask: Optional[torch.Tensor] = None,
                  mask_images: Optional[torch.Tensor] = None,
                  need_region: bool = False):
    """images_clip [B, MAX_IMG, S, S, 3] -> (feature buffer
    [B, MAX_IMG * L, H], L, region_fmap). Image i of a row sits at rows
    [i * L, (i + 1) * L): its projected (and, with the compressor,
    compressed) CLIP tokens, or, where image_is_mask marks a mask slot of
    the mask encoder, the encoded mask_images[:, i], both zero-padded to L.
    region_fmap (with need_region) comes from image slot 0: the raw CLIP
    features for the geo sampler, else the region adapter's output. The
    CLIP tower is frozen and runs without autograd (stop_gradient in the
    JAX package); the adapter, compressor and mask encoder keep theirs."""
    pc = cfg.projector
    b, n_img = images_clip.shape[:2]
    flat = images_clip.reshape((b * n_img,) + images_clip.shape[2:])
    with torch.no_grad():
        raw = clip.forward_features(params["clip"], flat, cfg.vision)
    proj = projector.apply_projector(params["mm_projector"], raw)
    if pc.token_compress:
        proj = projector.apply_token_compressor(
            params["mm_token_compressor"], proj, pc.compress_tokens)
    l_img = proj.shape[1]

    if pc.mask_encoder:
        if image_is_mask is None or mask_images is None:
            raise ValueError("the mask encoder reads Batch.image_is_mask and "
                             "mask_images (Batch.make fills them)")
        mflat = mask_images.reshape((b * n_img,) + mask_images.shape[2:])
        mask_feats = projector.apply_mask_encoder(
            params["mask_encoder"], mflat, pc.mask_encoder_tokens)
        l_max = max(l_img, pc.mask_encoder_tokens)
        pad = lambda x: torch.nn.functional.pad(  # noqa: E731
            x, (0, 0, 0, l_max - x.shape[1]))
        sel = image_is_mask.reshape(b * n_img, 1, 1).bool()
        feats = torch.where(sel, pad(mask_feats).to(proj.dtype), pad(proj))
    else:
        l_max, feats = l_img, proj

    region_fmap = None
    if need_region:
        raw0 = raw.reshape(b, n_img, raw.shape[1], raw.shape[2])[:, 0]
        region_fmap = (raw0 if pc.region_geo_sampler
                       else projector.apply_region_adapter(
                           params["region_fea_adapter"], raw0))
    return feats.reshape(b, n_img * l_max, -1), l_max, region_fmap


def _out_len(cfg: MedplibConfig, batch: Batch) -> int:
    """Static spliced length: T_in + MAX_IMG * (tokens per image, or mask
    tokens where larger) - MAX_IMG sentinel slots."""
    per = image_tokens_per_image(cfg)
    if cfg.projector.mask_encoder:
        per = max(per, cfg.projector.mask_encoder_tokens)
    return batch.input_ids.shape[1] + batch.image_token_lengths.shape[1] * (
        per - 1)


def splice_batch(params: Params, cfg: MedplibConfig, batch: Batch,
                 need_region: bool = False):
    """-> (embeds, labels_out, attn_mask, seg_mask, splice map). With
    need_region the region slots take the pooled (or geo-sampled) feature
    of each region mask."""
    buffer, l_max, region_fmap = encode_images(
        params, cfg, batch.images_clip, batch.image_is_mask,
        batch.mask_images, need_region)
    n_img = batch.images_clip.shape[1]
    dev = batch.input_ids.device
    starts = (torch.arange(n_img, device=dev) * l_max)[None, :].expand(
        batch.image_token_lengths.shape)
    sm = splice_ops.compute_splice_map(
        batch.input_ids, batch.input_mask, batch.image_token_lengths,
        out_len=_out_len(cfg, batch), image_feat_starts=starts)

    region_feats = None
    if need_region:
        if batch.region_masks is None or batch.region_valid is None:
            raise ValueError("rp_flag reads Batch.region_masks and "
                             "region_valid (Batch.make fills them)")
        if cfg.projector.region_geo_sampler:
            region_feats = geo_sampler.apply_geo_sampler(
                params["region_geo_sampler"], region_fmap,
                batch.region_masks, batch.region_valid,
                pooler_mode=cfg.projector.sampler_pooler_mode)
        else:
            region_feats = projector.region_pool(
                region_fmap, batch.region_masks, batch.region_valid)

    token_embeds = llama.embed(params["llm"], batch.input_ids)
    embeds, labels_out, seg_mask = splice_ops.splice_embeddings(
        sm, batch.input_ids, token_embeds, buffer,
        region_features=region_feats, labels=batch.labels,
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
                  rp_flag: bool = False, remat: bool = True,
                  max_segs: Optional[int] = None):
    """Teacher-forced forward -> dict of losses ("loss" is the total):
    shifted CE over the spliced labels, and with seg_flag the mask losses
    of every <SEG> slot decoded at gt_masks' size, valid where a SEG was
    found and mask_valid holds. rp_flag splices the region features. With
    train=False it also returns pred_masks and seg_valid."""
    embeds, labels_out, attn_mask, seg_mask, _ = splice_batch(
        params, cfg, batch, need_region=rp_flag)
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
             rp_flag: bool = False, out_size: Optional[int] = None,
             ground: bool = True, max_segs: int = 1,
             do_sample: bool = False, temperature=1.0, top_p=1.0,
             rng: sampling.Seed = None,
             kv_quant: bool = False) -> GenerateResult:
    """Decode + pixel grounding. SEG hidden states are captured inside the
    loop (prompt SEGs first, then generated ones, up to max_segs); a row
    with no SEG grounds the last step's projected hidden in slot 0.

    rp_flag: splice region features. out_size: mask side (default the SAM
    input size). ground=False skips SAM (pure VQA): zero masks.
    do_sample: temperature / top-p sampling (numbers or per-row [B]
    tensors; rows with temperature < 1e-4 stay greedy) from per-row
    streams seeded by rng (ops/sampling.row_keys: None is seed 0, an int,
    [B] per-row seeds or a [B, 2] state). kv_quant: int8 KV cache with
    per-token-per-head scales."""
    b = batch.input_ids.shape[0]
    dev = batch.input_ids.device
    embeds, _, attn_mask, seg_mask_prompt, _ = splice_batch(
        params, cfg, batch, need_region=rp_flag)
    cache = llama.KVCache.init(cfg.llm, b, embeds.shape[1] + max_new_tokens,
                               dtype=embeds.dtype, device=dev,
                               quant=kv_quant)
    hidden, cache, _ = _llm_forward(params, cfg, embeds, attn_mask, cache,
                                    train=False)
    last_idx = (attn_mask.sum(-1) - 1).clamp(min=0).long()
    last_hidden = torch.gather(
        hidden, 1, last_idx[:, None, None].expand(-1, 1, hidden.shape[-1]))
    fcs = params["text_hidden_fcs"]
    key = sub = None
    if do_sample:       # per-row streams; the values move to the device once
        temperature = sampling.per_row(temperature, dev)
        top_p = sampling.per_row(top_p, dev)
        key, sub = sampling.split_rows(sampling.row_keys(rng, b, dev))
    next_tok = sampling.select_token(
        llama.logits(params["llm"], last_hidden)[:, 0], sub, do_sample,
        temperature, top_p)

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
        if do_sample:
            key, sub = sampling.split_rows(key)
        new_tok = sampling.select_token(
            llama.logits(params["llm"], hidden)[:, 0], sub, do_sample,
            temperature, top_p)
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
    o = out_size or cfg.sam.image_size
    if ground:
        sam_emb = sam_med2d.encode_image(params["sam"]["image_encoder"],
                                         batch.images_sam, cfg.sam)
        pred, _ = decode_seg_masks(params, cfg, sam_emb, seg_emb, o)
    else:               # pure VQA: no SAM forward
        pred = torch.zeros((b, max_segs, o, o), device=dev)
    return GenerateResult(output_ids=output_ids, num_generated=num_generated,
                          pred_masks=pred, seg_valid=seg_valid,
                          has_seg=has_seg)
