"""MedPLIB composite model: CLIP -> projector -> splice -> (MoE-)LLaMA ->
<SEG> capture -> SAM-Med2D (medplib_tpu/models/medplib.py).

The port covers the pixel-grounding `generate` path with greedy decoding:
prefill into a KV cache, decode with the <SEG> hidden state captured
inside the loop, then one batched SAM encode + mask decode over every SEG
slot. Sampling, streaming, region / ICL inputs and training are not ported
yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.models import (clip, llama, moe_llama, projector,
                                      sam_med2d)
from medplib_tpu_torch.ops import splice as splice_ops
from medplib_tpu_torch.ops.initializers import dense_init

Params = Dict[str, Any]


class Batch(NamedTuple):
    """Static-shape batch: the fields of the JAX package's Batch that the
    generate path reads (ICL, region and training fields come with their
    slices)."""

    input_ids: torch.Tensor          # [B, T_in] with sentinel ids
    input_mask: torch.Tensor         # [B, T_in]
    labels: torch.Tensor             # [B, T_in]
    images_clip: torch.Tensor        # [B, MAX_IMG, S, S, 3]
    images_sam: torch.Tensor         # [B, S', S', 3]
    image_token_lengths: torch.Tensor  # [B, MAX_IMG]


def init_medplib(gen: torch.Generator, cfg: MedplibConfig,
                 dtype=torch.float32, device="cpu") -> Params:
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
    [B, MAX_IMG * L, H], L tokens per image)."""
    if cfg.projector.token_compress or cfg.projector.mask_encoder:
        raise NotImplementedError("ICL token compression / mask encoder "
                                  "are not ported yet")
    b, n_img = images_clip.shape[:2]
    flat = images_clip.reshape((b * n_img,) + images_clip.shape[2:])
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


def _llm_forward(params, cfg: MedplibConfig, embeds, attn_mask, cache=None):
    if cfg.moe.enable:
        return moe_llama.forward(params["llm"], cfg.llm, cfg.moe, embeds,
                                 attn_mask, cache=cache, train=False)
    return llama.forward(params["llm"], cfg.llm, embeds, attn_mask,
                         cache=cache)


def _llm_decode(params, cfg: MedplibConfig, embeds, cache):
    if cfg.moe.enable:
        return moe_llama.forward_decode(params["llm"], cfg.llm, cfg.moe,
                                        embeds, cache)
    return llama.forward_decode(params["llm"], cfg.llm, embeds, cache)


def decode_seg_masks(params: Params, cfg: MedplibConfig,
                     sam_embeddings: torch.Tensor, seg_embeds: torch.Tensor):
    """sam_embeddings [B, h, w, D]; seg_embeds [B, S, out_dim]
    -> (mask logits [B, S, size, size] at the SAM input size, iou [B, S])."""
    b, s, d = seg_embeds.shape
    sparse, dense = sam_med2d.encode_prompts(
        params["sam"]["prompt_encoder"], cfg.sam, b * s,
        text_embeds=seg_embeds.reshape(b * s, 1, d))
    img = sam_embeddings.repeat_interleave(s, dim=0)
    pe = sam_med2d.dense_pe(params["sam"]["prompt_encoder"], cfg.sam)
    low_res, iou = sam_med2d.decode_masks(
        params["sam"]["mask_decoder"], cfg.sam, img, pe, sparse, dense,
        multimask_output=False)
    out_size = cfg.sam.image_size
    masks = sam_med2d.postprocess_masks(low_res, out_size)
    return masks.reshape(b, s, out_size, out_size), iou.reshape(b, s)


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
             max_segs: int = 1) -> GenerateResult:
    """Greedy decode + pixel grounding. SEG hidden states are captured
    inside the loop (prompt SEGs first, then generated ones, up to
    max_segs); a row with no SEG grounds the last step's projected hidden
    in slot 0."""
    b = batch.input_ids.shape[0]
    dev = batch.input_ids.device
    embeds, _, attn_mask, seg_mask_prompt, _ = splice_batch(params, cfg,
                                                            batch)
    cache = llama.KVCache.init(cfg.llm, b, embeds.shape[1] + max_new_tokens,
                               dtype=embeds.dtype, device=dev)
    hidden, cache, _ = _llm_forward(params, cfg, embeds, attn_mask, cache)
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
