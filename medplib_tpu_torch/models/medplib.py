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
sampler), the streaming entry points of the serving engine
(stream_prefill / stream_decode_chunk, the chunked prefill
stream_prefill_begin -> stream_prefill_chunk -> stream_prefill_finish,
ground_seg_slots / stream_ground; generate runs on the same decode step),
and the training forward `model_forward` (CE + mask losses, the MoE
router aux loss, frozen CLIP and SAM encoders, per-layer remat), dense or
MoE (top-1 / top-2, Residual-MoE, mixed stacks).

Distribution: under a mesh (parallel/mesh.set_mesh) each rank passes its
rows of the global batch and its shards of the params; the losses are the
global masked means (models/losses), `ep_shard` runs the MoE experts
expert-parallel over the mesh's expert axis (models/moe_llama), CLIP and
SAM stay replicated and handle the rank's rows, and the language model
splits over the model axis (parallel/tp.py).

An MlaConfig language model (DeepSeek-V2, models/deepseek_v2.py) serves
through generate / stream_prefill / stream_decode_chunk with a latent
cache (models/mla.LatentCache, bf16); the chunked prefill and the int8
cache raise for it, as does expert parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from medplib_tpu_torch.config import MedplibConfig, is_mla
from medplib_tpu_torch.models import (clip, deepseek_v2, geo_sampler, llama,
                                      losses, mla, moe_llama, projector,
                                      sam_med2d)
from medplib_tpu_torch.ops import sampling
from medplib_tpu_torch.ops import splice as splice_ops
from medplib_tpu_torch.ops.initializers import dense_init
from medplib_tpu_torch.utils import profiling

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
    if is_mla(cfg.llm):
        llm = deepseek_v2.init_deepseek_v2(gen, cfg.llm, cfg.moe, dtype,
                                           cfg.vocab_size_padded, device)
    elif cfg.moe.enable:
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


@profiling.span("encode_images")
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
    with profiling.span("splice"):
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


def _deepseek(cfg: MedplibConfig, ep_shard: bool) -> bool:
    if is_mla(cfg.llm) and ep_shard:
        raise NotImplementedError("expert parallelism does not cover the "
                                  "DeepSeek-V2 MoE")
    return is_mla(cfg.llm)


def _llm_forward(params, cfg: MedplibConfig, embeds, attn_mask, cache=None,
                 train=True, remat=False, ep_shard=False):
    if _deepseek(cfg, ep_shard):
        if remat:
            raise NotImplementedError("MLA training (remat) is not ported")
        return deepseek_v2.forward(params["llm"], cfg.llm, cfg.moe, embeds,
                                   attn_mask, cache=cache)
    if cfg.moe.enable:
        return moe_llama.forward(params["llm"], cfg.llm, cfg.moe, embeds,
                                 attn_mask, cache=cache, remat=remat,
                                 train=train, ep_shard=ep_shard)
    return llama.forward(params["llm"], cfg.llm, embeds, attn_mask,
                         cache=cache, remat=remat)


def _llm_decode(params, cfg: MedplibConfig, embeds, cache, ep_shard=False):
    if _deepseek(cfg, ep_shard):
        return deepseek_v2.forward_decode(params["llm"], cfg.llm, cfg.moe,
                                          embeds, cache)
    if cfg.moe.enable:
        return moe_llama.forward_decode(params["llm"], cfg.llm, cfg.moe,
                                        embeds, cache, ep_shard=ep_shard)
    return llama.forward_decode(params["llm"], cfg.llm, embeds, cache)


@profiling.span("sam.decode")
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
                  ep_shard: bool = False, max_segs: Optional[int] = None):
    """Teacher-forced forward -> dict of losses ("loss" is the total):
    shifted CE over the spliced labels, and with seg_flag the mask losses
    of every <SEG> slot decoded at gt_masks' size, valid where a SEG was
    found and mask_valid holds. rp_flag splices the region features. With
    train=False it also returns pred_masks and seg_valid."""
    embeds, labels_out, attn_mask, seg_mask, _ = splice_batch(
        params, cfg, batch, need_region=rp_flag)
    hidden, _, aux = _llm_forward(params, cfg, embeds, attn_mask,
                                  train=train, remat=remat,
                                  ep_shard=ep_shard)
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


def _first_token(params, cfg: MedplibConfig, last_hidden, seg_emb,
                 seg_count, b, dev, do_sample, temperature, top_p,
                 rng: sampling.Seed):
    """The first new token from each row's last prompt hidden [B, 1, H]
    (a SEG there captures that hidden) -> (tok, seg_emb, seg_count,
    last_cap, stream keys after one split)."""
    logits = llama.logits(params["llm"], last_hidden)[:, 0]
    with profiling.span("sample"):
        key, sub = sampling.split_rows(sampling.row_keys(rng, b, dev))
        tok = sampling.select_token(logits, sub, do_sample, temperature,
                                    top_p)
        first_cap = text_hidden_fcs(params["text_hidden_fcs"],
                                    last_hidden)[:, 0]
        seg_emb, seg_count = _seg_slot_write(seg_emb, seg_count, first_cap,
                                             tok == cfg.seg_token_idx)
    return tok, seg_emb, seg_count, first_cap.to(seg_emb.dtype), key


def _make_decode_step(params, cfg: MedplibConfig, eos_id: int,
                      do_sample: bool, temperature, top_p, dev,
                      ep_shard: bool = False):
    """The decode step shared by generate and stream_decode_chunk.

    carry = (cache, tok, done, seg_emb [B, S, D], seg_count [B],
    last_cap [B, D], keys [B, 2]) -> (carry, (tok, done) as they came in).
    A SEG emitted now captures THIS step's hidden state (the state of the
    pass that predicted it). temperature / top_p: numbers or per-row
    values, moved to the device once here."""
    fcs = params["text_hidden_fcs"]
    if do_sample:
        temperature = sampling.per_row(temperature, dev)
        top_p = sampling.per_row(top_p, dev)

    def step(carry):
        cache, tok, done, seg_emb, seg_count, last_cap, key = carry
        emb = llama.embed(params["llm"], tok[:, None])
        hidden, cache = _llm_decode(params, cfg, emb, cache, ep_shard)
        logits = llama.logits(params["llm"], hidden)[:, 0]
        with profiling.span("sample"):
            sub = None
            if do_sample:
                key, sub = sampling.split_rows(key)
            new_tok = sampling.select_token(logits, sub, do_sample,
                                            temperature, top_p).to(tok.dtype)
            is_seg = (new_tok == cfg.seg_token_idx) & ~done
            cap = text_hidden_fcs(fcs, hidden)[:, 0]
            seg_emb, seg_count = _seg_slot_write(seg_emb, seg_count, cap,
                                                 is_seg)
            last_cap = torch.where(done[:, None], last_cap,
                                   cap.to(last_cap.dtype))
            new_tok = torch.where(done, torch.zeros_like(new_tok), new_tok)
            new_done = done | (new_tok == eos_id)
        return ((cache, new_tok, new_done, seg_emb, seg_count, last_cap,
                 key), (tok, done))

    return step


def _prompt_segs(params, hidden, seg_mask, max_segs, dtype):
    """Prompt-side SEG captures, left-packed -> (seg_emb, seg_count)."""
    p_emb, p_valid, _ = splice_ops.gather_seg_embeddings(
        text_hidden_fcs(params["text_hidden_fcs"], hidden), seg_mask,
        max_segs)
    seg_emb = torch.where(p_valid[..., None], p_emb,
                          torch.zeros_like(p_emb)).to(dtype)
    return seg_emb, p_valid.sum(1).to(torch.int32)


def _last_hidden(hidden, attn_mask):
    """Hidden state [B, 1, H] of each row's last real prompt token."""
    last_idx = (attn_mask.sum(-1) - 1).clamp(min=0).long()
    return torch.gather(
        hidden, 1, last_idx[:, None, None].expand(-1, 1, hidden.shape[-1]))


@profiling.span("generate")
@torch.no_grad()
def generate(params: Params, cfg: MedplibConfig, batch: Batch,
             max_new_tokens: int = 64, eos_id: int = 2,
             rp_flag: bool = False, out_size: Optional[int] = None,
             ground: bool = True, max_segs: int = 1,
             do_sample: bool = False, temperature=1.0, top_p=1.0,
             rng: sampling.Seed = None,
             kv_quant: bool = False,
             ep_shard: bool = False) -> GenerateResult:
    """Decode + pixel grounding. SEG hidden states are captured inside the
    loop (prompt SEGs first, then generated ones, up to max_segs); a row
    with no SEG grounds the last step's projected hidden in slot 0.

    rp_flag: splice region features. out_size: mask side (default the SAM
    input size). ground=False skips SAM (pure VQA): zero masks.
    do_sample: temperature / top-p sampling (numbers or per-row [B]
    tensors; rows with temperature < 1e-4 stay greedy) from per-row
    streams seeded by rng (ops/sampling.row_keys: None is seed 0, an int,
    [B] per-row seeds or a [B, 2] state). kv_quant: int8 KV cache with
    per-token-per-head scales. ep_shard: expert-parallel MoE under a
    mesh (module docstring)."""
    b = batch.input_ids.shape[0]
    dev = batch.input_ids.device
    state = stream_prefill(params, cfg, batch, max_new_tokens, rp_flag,
                           max_segs, do_sample, temperature, top_p, rng,
                           kv_quant, ep_shard)
    state, output_ids, dones = stream_decode_chunk(
        params, cfg, state, max_new_tokens, eos_id, do_sample, temperature,
        top_p, ep_shard)
    num_generated = (~dones).sum(1)
    has_seg = state.seg_count > 0
    seg_valid = (torch.arange(max_segs, device=dev)[None, :]
                 < state.seg_count[:, None])
    o = out_size or cfg.sam.image_size
    if ground:
        pred, _ = ground_seg_slots(params, cfg, batch.images_sam,
                                   state.seg_emb, state.seg_count,
                                   state.last_cap, o)
    else:               # pure VQA: no SAM forward
        pred = torch.zeros((b, max_segs, o, o), device=dev)
    return GenerateResult(output_ids=output_ids, num_generated=num_generated,
                          pred_masks=pred, seg_valid=seg_valid,
                          has_seg=has_seg)


# ---------------------------------------------------------------------------
# streaming generation (serving): prefill once, then decode in chunks so
# text can stream to the client mid-generation
# ---------------------------------------------------------------------------

class StreamState(NamedTuple):
    cache: llama.KVCache      # written in place by every decode step
    #                           (mla.LatentCache for an MLA model)
    tok: torch.Tensor         # [B] next input token
    done: torch.Tensor        # [B] bool
    seg_emb: torch.Tensor     # [B, S, out_dim] captured SEG slots
    seg_count: torch.Tensor   # [B] number of filled slots
    last_cap: torch.Tensor    # [B, out_dim] latest projected hidden
    rng: torch.Tensor         # [B, 2] per-row sampling streams


@profiling.span("prefill")
@torch.no_grad()
def stream_prefill(params: Params, cfg: MedplibConfig, batch: Batch,
                   max_new_tokens: int, rp_flag: bool = False,
                   max_segs: int = 1, do_sample: bool = False,
                   temperature=1.0, top_p=1.0, rng: sampling.Seed = None,
                   kv_quant: bool = False, ep_shard: bool = False
                   ) -> StreamState:
    """Splice + prefill into a cache of T + max_new_tokens positions ->
    the state for stream_decode_chunk, whose first token is already
    chosen (SEG capture as in generate: prompt SEGs, then a SEG as the
    first token captures the last prompt hidden). temperature / top_p:
    numbers or per-row values; rng as in generate."""
    b = batch.input_ids.shape[0]
    dev = batch.input_ids.device
    embeds, _, attn_mask, seg_mask, _ = splice_batch(
        params, cfg, batch, need_region=rp_flag)
    make = mla.LatentCache.init if is_mla(cfg.llm) else llama.KVCache.init
    cache = make(cfg.llm, b, embeds.shape[1] + max_new_tokens,
                 dtype=embeds.dtype, device=dev, quant=kv_quant)
    hidden, cache, _ = _llm_forward(params, cfg, embeds, attn_mask, cache,
                                    train=False, ep_shard=ep_shard)
    seg_emb, seg_count = _prompt_segs(params, hidden, seg_mask, max_segs,
                                      embeds.dtype)
    tok, seg_emb, seg_count, last_cap, key = _first_token(
        params, cfg, _last_hidden(hidden, attn_mask), seg_emb, seg_count, b,
        dev, do_sample, temperature, top_p, rng)
    return StreamState(cache=cache, tok=tok,
                       done=torch.zeros((b,), dtype=torch.bool, device=dev),
                       seg_emb=seg_emb, seg_count=seg_count,
                       last_cap=last_cap, rng=key)


@torch.no_grad()
def stream_decode_chunk(params: Params, cfg: MedplibConfig,
                        state: StreamState, chunk: int, eos_id: int = 2,
                        do_sample: bool = False, temperature=1.0, top_p=1.0,
                        ep_shard: bool = False):
    """Decode `chunk` tokens from the state (its cache is written in
    place) -> (new state, tokens [B, chunk], done-before-step
    [B, chunk]). The first token out is the one the state carried in."""
    step = _make_decode_step(params, cfg, eos_id, do_sample, temperature,
                             top_p, state.tok.device, ep_shard)
    carry, toks, dones = tuple(state), [], []
    for _ in range(chunk):
        with profiling.span("decode_step"):
            carry, (t, d) = step(carry)
        toks.append(t)
        dones.append(d)
    return (StreamState(*carry), torch.stack(toks, dim=1),
            torch.stack(dones, dim=1))


# ---------------------------------------------------------------------------
# chunked prefill (serving): the prompt is prefilled in fixed-size chunks
# so the engine can run decode chunks of the other slots between them.
# begin (splice + empty cache) -> N x chunk (extend) -> finish (first
# token).
# ---------------------------------------------------------------------------

class PrefillCarry(NamedTuple):
    cache: llama.KVCache      # length stays 0 until finish
    seg_emb: torch.Tensor     # [B, S, out_dim] prompt SEG slots so far
    seg_count: torch.Tensor   # [B]
    last_hidden: torch.Tensor  # [B, H] hidden at each row's last real pos


@profiling.span("prefill")
@torch.no_grad()
def stream_prefill_begin(params: Params, cfg: MedplibConfig, batch: Batch,
                         max_new_tokens: int, chunk_tokens: int,
                         rp_flag: bool = False, max_segs: int = 1,
                         kv_quant: bool = False,
                         cache_len: Optional[int] = None):
    """Splice the prompt and make an empty cache for chunked prefill ->
    (embeds, attn_mask, seg_mask, carry). The three are padded to whole
    chunks: padding queries write K/V past every row's true length, which
    decode never reads (it masks by cache.length, set at finish). The
    cache holds cache_len positions (default the padded prompt +
    max_new_tokens), at least the padded prompt."""
    b = batch.input_ids.shape[0]
    dev = batch.input_ids.device
    embeds, _, attn_mask, seg_mask, _ = splice_batch(params, cfg, batch,
                                                     need_region=rp_flag)
    n = -(-embeds.shape[1] // chunk_tokens)
    pad = n * chunk_tokens - embeds.shape[1]
    if pad:
        embeds = torch.nn.functional.pad(embeds, (0, 0, 0, pad))
        attn_mask = torch.nn.functional.pad(attn_mask, (0, pad))
        seg_mask = torch.nn.functional.pad(seg_mask, (0, pad))
    maxlen = max(cache_len or (embeds.shape[1] + max_new_tokens),
                 n * chunk_tokens)
    cache = llama.KVCache.init(cfg.llm, b, maxlen, dtype=embeds.dtype,
                               device=dev, quant=kv_quant)
    out_dim = params["text_hidden_fcs"]["fc2"]["kernel"].shape[1]
    carry = PrefillCarry(
        cache=cache,
        seg_emb=torch.zeros((b, max_segs, out_dim), dtype=embeds.dtype,
                            device=dev),
        seg_count=torch.zeros((b,), dtype=torch.int32, device=dev),
        last_hidden=torch.zeros((b, embeds.shape[-1]), dtype=embeds.dtype,
                                device=dev))
    return embeds, attn_mask, seg_mask, carry


def _llm_extend(params, cfg: MedplibConfig, embeds, cache, c0,
                ep_shard=False):
    if cfg.moe.enable:
        return moe_llama.forward_extend(params["llm"], cfg.llm, cfg.moe,
                                        embeds, cache, c0, ep_shard=ep_shard)
    return llama.forward_extend(params["llm"], cfg.llm, embeds, cache, c0)


@profiling.span("prefill")
@torch.no_grad()
def stream_prefill_chunk(params: Params, cfg: MedplibConfig,
                         carry: PrefillCarry, embeds: torch.Tensor,
                         attn_mask: torch.Tensor, seg_mask: torch.Tensor,
                         c0: int, chunk_tokens: int,
                         ep_shard: bool = False) -> PrefillCarry:
    """Prompt positions [c0, c0 + chunk_tokens): extend the cache (in
    place), append the chunk's prompt-SEG captures to the slots in
    sequence order, and track each row's last-real-position hidden."""
    c0 = int(c0)
    span = slice(c0, c0 + chunk_tokens)
    hidden, cache = _llm_extend(params, cfg, embeds[:, span], carry.cache,
                                c0, ep_shard)
    max_segs = carry.seg_emb.shape[1]
    p_emb, p_valid, _ = splice_ops.gather_seg_embeddings(
        text_hidden_fcs(params["text_hidden_fcs"], hidden),
        seg_mask[:, span].bool(), max_segs)
    seg_emb, seg_count = carry.seg_emb, carry.seg_count
    for j in range(max_segs):
        seg_emb, seg_count = _seg_slot_write(seg_emb, seg_count,
                                             p_emb[:, j], p_valid[:, j])
    last_idx = (attn_mask.sum(-1).to(torch.int32) - 1).clamp(min=0)
    li = ((last_idx.clamp(max=c0 + chunk_tokens - 1) - c0)
          .clamp(0, chunk_tokens - 1).long())
    lh = torch.gather(hidden, 1, li[:, None, None].expand(
        -1, 1, hidden.shape[-1]))[:, 0]
    last_hidden = torch.where((last_idx >= c0)[:, None],
                              lh.to(carry.last_hidden.dtype),
                              carry.last_hidden)
    return PrefillCarry(cache=cache, seg_emb=seg_emb, seg_count=seg_count,
                        last_hidden=last_hidden)


@profiling.span("prefill")
@torch.no_grad()
def stream_prefill_finish(params: Params, cfg: MedplibConfig,
                          carry: PrefillCarry, attn_mask: torch.Tensor,
                          do_sample: bool = False, temperature=1.0,
                          top_p=1.0, rng: sampling.Seed = None
                          ) -> StreamState:
    """Choose the first token from the chunked-prefill carry and seal the
    cache (length := the prompt mask's row sums), as stream_prefill
    does."""
    b = attn_mask.shape[0]
    dev = attn_mask.device
    tok, seg_emb, seg_count, last_cap, key = _first_token(
        params, cfg, carry.last_hidden[:, None], carry.seg_emb,
        carry.seg_count, b, dev, do_sample, temperature, top_p, rng)
    cache = dataclasses.replace(
        carry.cache, length=attn_mask.int().sum(-1).to(torch.int32))
    return StreamState(cache=cache, tok=tok,
                       done=torch.zeros((b,), dtype=torch.bool, device=dev),
                       seg_emb=seg_emb, seg_count=seg_count,
                       last_cap=last_cap, rng=key)


@profiling.span("ground")
@torch.no_grad()
def ground_seg_slots(params: Params, cfg: MedplibConfig,
                     images_sam: torch.Tensor, seg_emb: torch.Tensor,
                     seg_count: torch.Tensor, last_cap: torch.Tensor,
                     out_size: Optional[int] = None):
    """SAM encode + mask decode of the captured SEG slots (the fallback
    last_cap in slot 0 of a row with none). images_sam [B, S', S', 3];
    seg_emb [B, S, out_dim] (not modified); seg_count [B]; last_cap
    [B, out_dim] -> (mask logits [B, S, out, out], seg_valid [B, S])."""
    has_seg = seg_count > 0
    seg_emb = seg_emb.clone()
    seg_emb[:, 0] = torch.where(has_seg[:, None], seg_emb[:, 0],
                                last_cap.to(seg_emb.dtype))
    sam_emb = sam_med2d.encode_image(params["sam"]["image_encoder"],
                                     images_sam, cfg.sam)
    masks, _ = decode_seg_masks(params, cfg, sam_emb, seg_emb,
                                out_size or cfg.sam.image_size)
    s = seg_emb.shape[1]
    seg_valid = (torch.arange(s, device=seg_emb.device)[None, :]
                 < seg_count[:, None])
    return masks, seg_valid


def stream_ground(params: Params, cfg: MedplibConfig, batch: Batch,
                  state: StreamState, out_size: Optional[int] = None):
    """Grounding of a finished stream -> (mask logits [B, S, out, out],
    seg_valid [B, S])."""
    return ground_seg_slots(params, cfg, batch.images_sam, state.seg_emb,
                            state.seg_count, state.last_cap, out_size)
