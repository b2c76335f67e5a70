"""The serving comparison of a DeepSeek-V2 configuration: reference/
serve.py's pipeline (CLIP, projector, splice, teacher-forced decoder,
lm_head, SAM over each row's <SEG> hidden) with the decoder of
reference/dsv2.py. The readings are serve.py's."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from portbench.reference import dsv2, serve
from portbench.reference import model as ref


def run(model: dict, mix: dict, seed: int, calls: Sequence[int],
        served: Sequence[np.ndarray], device, bits: int) -> Dict:
    """serve.run with the DeepSeek-V2 decoder: -> {"logits", "tokens",
    "masks"}."""
    W = ref.Weights(seed, device)
    med = model["medplib"]
    table = ref.embedding_table(W, model)
    rows = serve._rows(model, mix, seed, calls, served, device)
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
    hidden = dsv2.decoder(W, model, x, lens, bits)
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
