"""The serving comparison: the plain reference over the prompts of the
calls a run finished, teacher-forced with the tokens the program served.

For every served token (up to and with the row's end-of-sequence token)
the reference gives the logits at that position, and the gap by which the
served token's logit lies below the reference's best there (0 where the
program served the reference's argmax). For each row's mask, the relative
L2 distance between the program's mask logits and the reference's, whose
<SEG> hidden state comes from the same prompt. The numbers are the mean
and the widest of each, and the rows' median distance; the cell's file
says which are compared.

`control` runs the same pipeline with the configuration's int8 linears
(attention, lm_head, projector) stored in int4 instead: the step a later
change would be tempted to take. Its gap is that of the token it puts
first at each position; its mask is compared as the program's is.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import traffic
from portbench.reference import model as ref


def _rows(model: dict, mix: dict, seed: int, calls: Sequence[int],
          served: Sequence[np.ndarray], device):
    """-> per row (batch of the call, row index, served tokens kept)."""
    eos = model["eos_token_id"]
    rows = []
    for call, toks in zip(calls, served):
        batch = traffic.make(mix, model, seed, call, device)
        for r in range(toks.shape[0]):
            t = [int(x) for x in toks[r]]
            if eos in t:
                t = t[:t.index(eos) + 1]
            rows.append((batch, r, t))
    return rows


def run(model: dict, mix: dict, seed: int, calls: Sequence[int],
        served: Sequence[np.ndarray], device, bits: int) -> Dict:
    """The reference (bits=8) or the control (bits=4) over the rows of
    `calls`: -> {"logits": [tokens, V] f32 at every served position,
    "tokens": the served ids, "masks": [rows, S, S]}."""
    W = ref.Weights(seed, device)
    med = model["medplib"]
    table = ref.embedding_table(W, model)
    rows = _rows(model, mix, seed, calls, served, device)
    vocab = med["vocab_size_padded"]
    for _, _, t in rows:
        if any(x < 0 or x >= vocab for x in t):
            raise ValueError("a served token lies outside the vocabulary")
    at = mix["image_at"]
    clip_px = torch.cat([b["clip"][r:r + 1, 0] for b, r, _ in rows])
    sam_px = torch.cat([b["sam"][r:r + 1] for b, r, _ in rows])
    feats = torch.cat([ref.clip_features(W, med["vision"], clip_px[i:i + 8])
                       for i in range(0, len(rows), 8)])
    feats = ref.projector(W, model, feats, bits)
    n_img = feats.shape[1]
    seqs, prompt_len, seg_pos = [], [], []
    for i, (b, r, t) in enumerate(rows):
        n = int(b["lens"][r])
        ids = b["ids"][r, :n]
        seg_at = int((ids == med["seg_token_idx"]).nonzero()[0, 0])
        idx = torch.cat([ids[:at], ids[at + 1:],
                         torch.as_tensor(t[:-1], device=device,
                                         dtype=ids.dtype)])
        text = table[idx.long()].float()
        seqs.append(torch.cat([text[:at], feats[i], text[at:]]))
        prompt_len.append(n - 1 + n_img)
        seg_pos.append(seg_at - 1 + n_img - 1)   # the token before <SEG>
    del feats, table
    lens = [s.shape[0] for s in seqs]
    x = torch.zeros((len(rows), max(lens), model["hidden_size"]),
                    device=device)
    for i, s in enumerate(seqs):
        x[i, :lens[i]] = s
    del seqs
    hidden = ref.decoder(W, model, x, lens, bits)
    pos = [(i, prompt_len[i] - 1 + j) for i, (_, _, t) in enumerate(rows)
           for j in range(len(t))]
    ii = torch.as_tensor([p[0] for p in pos], device=device)
    jj = torch.as_tensor([p[1] for p in pos], device=device)
    logits = ref.lm_head(W, model, hidden[ii, jj], bits)
    seg_h = hidden[torch.arange(len(rows), device=device),
                   torch.as_tensor(seg_pos, device=device)]
    del hidden, x
    text_emb = ref.text_hidden_fcs(W, model, seg_h)
    masks = []
    for i in range(0, len(rows), 8):
        emb = ref.sam_image(W, med["sam"], sam_px[i:i + 8])
        masks.append(ref.sam_mask(W, med["sam"], emb, text_emb[i:i + 8]))
    tokens = torch.as_tensor([x for _, _, t in rows for x in t],
                             device=device)
    return {"logits": logits, "tokens": tokens, "masks": torch.cat(masks)}


def mask_rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each row's ||got - want|| / ||want||."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp(min=1e-30)


def _numbers(g: torch.Tensor, rel: torch.Tensor) -> Dict[str, float]:
    return {"logit_gap_mean": float(g.mean()),
            "mask_rel_median": float(rel.median()),
            "mask_rel_mean": float(rel.mean()),
            "logit_gap_max": float(g.max()),
            "mask_rel_max": float(rel.max()),
            "token_agree": float((g == 0).float().mean()),
            "tokens": int(g.numel())}


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, chosen[:, None].long())[:, 0]


def readings(want: Dict, masks: torch.Tensor) -> Dict[str, float]:
    """The program's numbers against the reference's run `want` (whose
    tokens are the program's) and the program's masks [rows, S, S]."""
    g = gaps(want["logits"], want["tokens"])
    if not bool(torch.isfinite(masks).all()):
        return _numbers(g, torch.full((masks.shape[0],), float("inf")))
    return _numbers(g, mask_rel(masks, want["masks"]))


def control_readings(want: Dict, control: Dict) -> Dict[str, float]:
    """The control's numbers: the gap of the token it puts first at each
    served position, its masks against the reference's."""
    g = gaps(want["logits"], control["logits"].argmax(dim=-1))
    return _numbers(g, mask_rel(control["masks"], want["masks"]))


def program_masks(masks: List[torch.Tensor], device) -> torch.Tensor:
    """The program's [B, 1, S, S] mask logits of each call -> [rows, S, S]."""
    return torch.cat([m[:, 0].to(device) for m in masks])
