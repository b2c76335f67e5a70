"""Multimodal token splice as batched static-shape gathers
(medplib_tpu/ops/splice.py): each input token expands to its output span
(image sentinel -> that image's token count, padding -> 0), an exclusive
cumsum gives span starts, and a searchsorted maps every output slot back to
its source token; one gather per source kind assembles the embeddings."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from medplib_tpu_torch.config import (IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                      REGION_TOKEN_INDEX)


class SpliceMap(NamedTuple):
    src_idx: torch.Tensor         # [B, T_out] source input-token index
    within: torch.Tensor          # [B, T_out] offset within that span
    is_image: torch.Tensor        # [B, T_out] slot takes an image feature
    is_region: torch.Tensor       # [B, T_out] slot takes a region feature
    image_flat_idx: torch.Tensor  # [B, T_out] row into the image buffer
    region_ordinal: torch.Tensor  # [B, T_out] which region feature
    attn_mask: torch.Tensor       # [B, T_out] 1 = real slot (int32)
    total_len: torch.Tensor       # [B]


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1) - x


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, idx)


def compute_splice_map(input_ids: torch.Tensor, input_mask: torch.Tensor,
                       image_token_lengths: torch.Tensor, out_len: int,
                       image_feat_starts: Optional[torch.Tensor] = None
                       ) -> SpliceMap:
    b, t_in = input_ids.shape
    dev = input_ids.device
    n_img = image_token_lengths.shape[1]
    lengths = image_token_lengths.long()
    is_img_tok = input_ids == IMAGE_TOKEN_INDEX
    img_ordinal = _exclusive_cumsum(is_img_tok.long())
    per_tok_img_len = _take(lengths, img_ordinal.clamp(0, n_img - 1))
    exp_len = torch.where(is_img_tok, per_tok_img_len,
                          torch.ones_like(per_tok_img_len))
    exp_len = exp_len * input_mask.long()
    start = _exclusive_cumsum(exp_len)
    total = start[:, -1] + exp_len[:, -1]

    out_pos = torch.arange(out_len, device=dev)[None, :].expand(b, out_len)
    # last token whose start <= j; zero-length (padding) tokens share the
    # next real start, so searchsorted(right) skips them
    src_idx = torch.searchsorted(start.contiguous(), out_pos.contiguous(),
                                 right=True) - 1
    src_idx = src_idx.clamp(0, t_in - 1)
    within = out_pos - _take(start, src_idx)

    src_ids = _take(input_ids, src_idx)
    valid = out_pos < total[:, None]
    is_image = (src_ids == IMAGE_TOKEN_INDEX) & valid
    is_region = (src_ids == REGION_TOKEN_INDEX) & valid

    if image_feat_starts is None:
        img_feat_start = _exclusive_cumsum(lengths)
    else:
        img_feat_start = image_feat_starts.long()
    src_img_ordinal = _take(img_ordinal, src_idx).clamp(0, n_img - 1)
    image_flat_idx = _take(img_feat_start, src_img_ordinal) + within

    region_ord_per_tok = _exclusive_cumsum(
        (input_ids == REGION_TOKEN_INDEX).long())
    region_ordinal = _take(region_ord_per_tok, src_idx)

    return SpliceMap(src_idx=src_idx, within=within, is_image=is_image,
                     is_region=is_region,
                     image_flat_idx=image_flat_idx.clamp(min=0),
                     region_ordinal=region_ordinal,
                     attn_mask=valid.int(), total_len=total)


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, N, H], idx [B, T] -> [B, T, H]."""
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def splice_embeddings(sm: SpliceMap, input_ids: torch.Tensor,
                      token_embeds: torch.Tensor,
                      image_features: torch.Tensor,
                      region_features: Optional[torch.Tensor] = None,
                      labels: Optional[torch.Tensor] = None,
                      seg_token_idx: Optional[int] = None):
    """-> (embeds [B, T_out, H], labels_out|None, seg_mask|None)."""
    text = _gather_rows(token_embeds, sm.src_idx)
    img = _gather_rows(image_features, sm.image_flat_idx.clamp(
        0, image_features.shape[1] - 1))
    out = torch.where(sm.is_image[..., None], img.to(text.dtype), text)
    if region_features is not None:
        reg = _gather_rows(region_features, sm.region_ordinal.clamp(
            0, region_features.shape[1] - 1))
        out = torch.where(sm.is_region[..., None], reg.to(out.dtype), out)
    out = out * sm.attn_mask[..., None].to(out.dtype)

    labels_out = None
    if labels is not None:
        lab = _take(labels, sm.src_idx)
        text_slot = (~sm.is_image) & (~sm.is_region) & (sm.attn_mask > 0)
        labels_out = torch.where(text_slot & (sm.within == 0), lab,
                                 torch.full_like(lab, IGNORE_INDEX))

    seg_mask = None
    if seg_token_idx is not None:
        # source tokens whose NEXT token is <SEG>
        next_ids = torch.cat([input_ids[:, 1:],
                              torch.zeros_like(input_ids[:, :1])], dim=1)
        seg_here = _take(next_ids == seg_token_idx, sm.src_idx)
        text_slot = (~sm.is_image) & (sm.attn_mask > 0) & (sm.within == 0)
        seg_mask = seg_here & text_slot
    return out, labels_out, seg_mask


def gather_seg_embeddings(hidden: torch.Tensor, seg_mask: torch.Tensor,
                          max_segs: int):
    """First `max_segs` SEG-marked hidden states per row, in sequence order.
    hidden [B, T, H]; seg_mask [B, T] bool -> (embeds [B, S, H], valid
    [B, S], idx [B, S]). A stable descending sort of -position reproduces
    lax.top_k's lower-index-first tie order."""
    b, t, h = hidden.shape
    pos = torch.arange(t, device=hidden.device)[None, :].expand(b, t)
    score = torch.where(seg_mask, -pos, torch.full_like(pos, -t - 1))
    idx = torch.sort(score, dim=1, descending=True,
                     stable=True).indices[:, :max_segs]
    valid = torch.gather(seg_mask, 1, idx)
    return _gather_rows(hidden, idx), valid, idx
