"""The training comparison: the plain float32 reference follows a cell's
first steps from the same seeded weights and batches.

The model is the dense decoder of reference/model.py with LoRA on the
target projections: y = x W + dropout(x) A B * alpha / r. The frozen
language model's linears are stored in `bits` (the configuration's int8;
4 for the int4 control); with `act8` every decoder linear's and lm_head's
input is rounded to float8 (the float8 control). The projector, CLIP and
SAM's encoders stay as drawn. Trainable: the adapters, the token
embedding, text_hidden_fcs and SAM's mask decoder (and the region
adapter, which this forward never reads); lm_head is int8 in a QLoRA
tree and so frozen, as quantized weights are. Loss: next-token cross entropy over the spliced labels plus
the weighted sigmoid BCE and dice of each row's <SEG> mask. Then the
global-norm clip and AdamW (bias-corrected moments, eps outside the root,
the learning-rate schedule from the configuration). Trainable weights are
kept in the configuration's dtype (bf16) between steps, as the program
stores them; the arithmetic is float32.

LoRA dropout. The configuration's program draws each mask from a
generator seeded by an FNV mix of (step seed, layer, call within the
layer); the reference works the same masks out again, so both sides drop
the same inputs. The decoder runs layer by layer under checkpointing so
that it fits on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import traffic, weights
from portbench.reference import model as ref
from portbench.reference import quant

IGNORE = -100


def mix_seed(*xs: int) -> int:
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = ((h ^ (x & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) % (1 << 63)
    return h


def step_seed(model: dict, step: int) -> int:
    """The dropout seed of step `step` (one microbatch)."""
    return mix_seed(model["training"]["seed"] ^ 0x10A4, step, 0)


class Params:
    """The weights: trainable leaves held as float32 tensors that keep
    their gradients (stacked [L, ...] leaves whole), frozen ones drawn
    when asked for."""

    def __init__(self, model: dict, seed: int, device):
        self.model, self.seed, self.device = model, seed, device
        t = model["training"]
        self.prefixes = tuple(
            [f"llm/layers/attn/{n}/lora_" for n in t["lora_target_modules"]]
            + [m + "/" for m in ("text_hidden_fcs", "region_fea_adapter")]
            + ["sam/mask_decoder/", "llm/embed_tokens/"])
        self.leaves: Dict[str, torch.Tensor] = {}

    def trainable(self, path: str) -> bool:
        return path.startswith(self.prefixes)

    def leaf(self, path: str, shape) -> torch.Tensor:
        if path not in self.leaves:
            if weights.is_stacked(path):
                t = torch.stack([weights.draw(self.seed, path, shape[1:],
                                              self.device, layer=i)
                                 for i in range(shape[0])])
            else:
                t = weights.draw(self.seed, path, shape, self.device)
            self.leaves[path] = t.float().requires_grad_(True)
        return self.leaves[path]

    def __call__(self, path: str, shape, layer=None):
        if not self.trainable(path):
            return weights.draw(self.seed, path, shape, self.device,
                                layer).float()
        if layer is None:
            return self.leaf(path, shape)
        L = self.model["num_hidden_layers"]
        return self.leaf(path, (L,) + tuple(shape))[layer]


def _dropout(x, seed, layer, call, rate):
    if rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(mix_seed(seed, layer, call))
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale (amax / 448), the rounding
    passed straight through in the backward."""
    s = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


def decoder(P: Params, model: dict, x, valid, drop_seed: int, bits: int,
            act8: bool = False):
    """x [B, T, H] (rows real where `valid`) -> final-norm hidden states;
    each layer checkpointed (recomputed in the backward). act8: every
    linear's input rounded to float8 (the control)."""
    a8 = fp8 if act8 else (lambda z: z)
    h, L = model["hidden_size"], model["num_hidden_layers"]
    m, eps = model["intermediate_size"], model["rms_norm_eps"]
    heads, d = model["num_attention_heads"], model["head_dim"]
    kvh = model["num_key_value_heads"]
    t = model["training"]
    rate, r = t["lora_dropout"], t["lora_r"]
    scale = t["lora_alpha"] / r
    b, n = x.shape[:2]
    pos = torch.arange(n, device=x.device)
    keep = (pos[None, :] <= pos[:, None])[None, None] & \
        valid[:, None, None, :]
    outs = {"q_proj": heads * d, "k_proj": kvh * d, "v_proj": kvh * d}
    targets = t["lora_target_modules"]

    def layer(i, x, *adapters):
        ad = dict(zip([(nm, k) for nm in targets for k in ("a", "b")],
                      adapters))

        def w(name, shape):
            return P(f"llm/layers/{name}", shape, i)
        y = a8(ref.rms_norm(x, w("input_layernorm/weight", (h,)), eps))
        proj, call = {}, 0
        for nm in ("q_proj", "k_proj", "v_proj"):
            kern = quant.linear_weight(w(f"attn/{nm}/kernel", (outs[nm], h)),
                                       1, bits)
            z = y @ kern.t()
            if nm in targets:
                call += 1
                z = z + (_dropout(y, drop_seed, i, call, rate)
                         @ ad[(nm, "a")] @ ad[(nm, "b")]) * scale
            proj[nm] = z
        q = proj["q_proj"].reshape(b, n, heads, d).transpose(1, 2)
        k = proj["k_proj"].reshape(b, n, kvh, d).transpose(1, 2)
        v = proj["v_proj"].reshape(b, n, kvh, d).transpose(1, 2)
        q, k = ref._rope(q, pos, model["rope_theta"]), \
            ref._rope(k, pos, model["rope_theta"])
        if kvh != heads:
            k = k.repeat_interleave(heads // kvh, dim=1)
            v = v.repeat_interleave(heads // kvh, dim=1)
        s = (q @ k.transpose(-1, -2) / math.sqrt(d)).masked_fill(
            ~keep, float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b, n, -1)
        ow = quant.linear_weight(w("attn/o_proj/kernel", (heads * d, h)), 0,
                                 bits)
        x = x + a8(o) @ ow
        y = a8(ref.rms_norm(x, w("post_attention_layernorm/weight", (h,)),
                            eps))
        g = y @ quant.linear_weight(w("mlp/gate_proj/kernel", (h, m)), 0,
                                    bits)
        u = y @ quant.linear_weight(w("mlp/up_proj/kernel", (h, m)), 0, bits)
        dn = quant.linear_weight(w("mlp/down_proj/kernel", (m, h)), 0, bits)
        return x + a8(g * torch.sigmoid(g) * u) @ dn

    for i in range(L):
        adapters = []
        for nm in targets:
            adapters.append(P(f"llm/layers/attn/{nm}/lora_a", (h, r), i))
            adapters.append(P(f"llm/layers/attn/{nm}/lora_b",
                              (r, outs[nm]), i))
        x = checkpoint(layer, i, x, *adapters, use_reentrant=False)
    return ref.rms_norm(x, P("llm/norm/weight", (h,)), eps)


def _ce_sum(hidden, labels, kern):
    """Summed next-token NLL over the targets that are not IGNORE."""
    logits = hidden[:, :-1] @ kern
    tgt = labels[:, 1:]
    ok = tgt != IGNORE
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, tgt.clamp(min=0)[..., None])[..., 0]
    return torch.where(ok, nll, torch.zeros_like(nll)).sum()


def loss_of(P: Params, model: dict, mix: dict, seed: int, call: int,
            step: int, bits: int, device, rows: Optional[int] = None,
            act8: bool = False) -> torch.Tensor:
    """The step's loss on batch `call` (dropout of step `step`)."""
    med, t = model["medplib"], model["training"]
    h = model["hidden_size"]
    b = traffic.make(mix, model, seed, call, device)
    if rows is not None:
        b = {k: v[:rows] if k != "new_tokens" else v for k, v in b.items()}
    at, n_img = mix["image_at"], (med["vision"]["image_size"]
                                  // med["vision"]["patch_size"]) ** 2
    with torch.no_grad():
        feats = torch.cat([ref.clip_features(P, med["vision"],
                                             b["clip"][i:i + 8, 0])
                           for i in range(0, b["clip"].shape[0], 8)])
        feats = ref.projector(P, model, feats, 16)
    table = P("llm/embed_tokens/embedding", (med["vocab_size_padded"], h))
    rows, labels, seg_pos = [], [], []
    t_out = b["ids"].shape[1] - 1 + n_img
    for r, n in enumerate(b["lens"]):
        n = int(n)
        ids, lab = b["ids"][r, :n], b["labels"][r, :n]
        emb = table[torch.cat([ids[:at], ids[at + 1:]]).long()]
        x = torch.cat([emb[:at], feats[r], emb[at:]])
        rows.append(F.pad(x, (0, 0, 0, t_out - x.shape[0])))
        lab = torch.cat([lab[:at], torch.full((n_img,), IGNORE,
                                              device=device), lab[at + 1:]])
        labels.append(F.pad(lab, (0, t_out - lab.shape[0]), value=IGNORE))
        seg_at = int((ids == med["seg_token_idx"]).nonzero()[0, 0])
        seg_pos.append(seg_at - 2 + n_img)
    x, labels = torch.stack(rows), torch.stack(labels).long()
    valid = (torch.arange(t_out, device=device)[None, :]
             < torch.as_tensor([int(n) - 1 + n_img for n in b["lens"]],
                               device=device)[:, None])
    hidden = decoder(P, model, x, valid, step_seed(model, step), bits,
                     act8)
    if act8:
        hidden = fp8(hidden)
    head = quant.linear_weight(P("llm/lm_head/kernel",
                                 (h, med["vocab_size_padded"])), 0, bits)
    nll = sum(checkpoint(_ce_sum, hidden[i:i + 2], labels[i:i + 2], head,
                         use_reentrant=False)
              for i in range(0, x.shape[0], 2))
    ce = nll / (labels[:, 1:] != IGNORE).sum().clamp(min=1)
    seg_h = hidden[torch.arange(x.shape[0], device=device),
                   torch.as_tensor(seg_pos, device=device)]
    text = ref.text_hidden_fcs(P, model, seg_h)
    with torch.no_grad():
        img = torch.cat([ref.sam_image(P, med["sam"], b["sam"][i:i + 8])
                         for i in range(0, b["sam"].shape[0], 8)])
    pred = ref.sam_mask(P, med["sam"], img, text).flatten(1)
    gt = b["gt"][:, 0].flatten(1)
    bce = (pred.clamp(min=0) - pred * gt
           + torch.log1p(torch.exp(-pred.abs()))).mean(-1).mean()
    p = torch.sigmoid(pred)
    dice = (1.0 - (2.0 * (p * gt).sum(-1) + 1e-6)
            / (p.sum(-1) + gt.sum(-1) + 1e-6)).mean()
    return (t["ce_loss_weight"] * ce + t["bce_loss_weight"] * bce
            + t["dice_loss_weight"] * dice)


def run(model: dict, mix: dict, seed: int, steps: int, device,
        bits: int, rows: Optional[int] = None, act8: bool = False) -> Dict:
    """The first `steps` steps -> {"losses", "grad_norms" (the clipped
    first gradient, per leaf), "change_norms" (per leaf, over the steps),
    "embed_rows" (the embedding rows the first gradient touches)}.
    `rows` keeps only each batch's first rows (the loss their mean): a
    fault planted in the reference, for calibration. `act8`: the
    decoder's and lm_head's inputs in float8 (the control)."""
    t = model["training"]
    P = Params(model, seed, device)
    b1, b2, lr = t["beta1"], t["beta2"], t["lr"]
    losses, grad_norms = [], {}
    mu: Dict[str, torch.Tensor] = {}
    nu: Dict[str, torch.Tensor] = {}
    start: Dict[str, torch.Tensor] = {}
    for step in range(steps):
        loss = loss_of(P, model, mix, seed, step, step, bits, device, rows,
                       act8)
        losses.append(float(loss.detach()))
        names = list(P.leaves)
        grads = torch.autograd.grad(loss, [P.leaves[k] for k in names])
        if step == 0:
            start = {k: P.leaves[k].detach().clone() for k in names}
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        clip = min(1.0, t["grad_clip_norm"] / float(g_norm))
        grads = [g * clip for g in grads]
        if step == 0:
            grad_norms = {k: float(g.norm()) for k, g in zip(names, grads)}
            embed_rows = {k: rows_touched(g) for k, g in zip(names, grads)
                          if k.endswith("/embedding")}
        c = step + 1
        rate = _schedule(t, step)
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = P.leaves[k]
                mu[k] = (1 - b1) * g + b1 * mu.get(k, torch.zeros_like(g))
                nu[k] = (1 - b2) * g * g + b2 * nu.get(k,
                                                      torch.zeros_like(g))
                u = (mu[k] / (1 - b1 ** c)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** c)) + 1e-8)
                u = u + t["weight_decay"] * p
                p.copy_((p - rate * u).to(getattr(torch, t["dtype"])))
        del grads
    change = {k: float((P.leaves[k].detach() - start[k]).norm())
              for k in start}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "embed_rows": embed_rows}


def rows_touched(g: torch.Tensor) -> int:
    """Rows of an embedding's gradient above a thousandth of the median
    nonzero row's norm: the tokens the batch holds."""
    norms = g.detach().float().norm(dim=-1)
    live = norms[norms > 0]
    if live.numel() == 0:
        return 0
    return int((norms > 1e-3 * live.median()).sum())


def _schedule(t: dict, count: int) -> float:
    """Warm-up from 0 to lr over warmup_steps, then linear decay to 0 at
    total_steps: the rate of the update that follows `count` updates."""
    w, total, lr = t["warmup_steps"], t["total_steps"], t["lr"]
    if count < w:
        return lr * count / w
    return lr * (1.0 - min(count - w, total - w) / max(total - w, 1))


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               kept: List[str]) -> Dict[str, float]:
    """Per leaf: |norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[k] for k in kept]))
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med)
            for k in kept}


def readings(prog: Dict, want: Dict) -> Dict[str, float]:
    """The program's numbers against the reference's. Leaves whose
    reference gradient is below a thousandth of the median leaf's (nought
    to rounding: unused leaves, or moved by Adam's round-off alone) are
    left out of the leaf numbers."""
    g = want["grad_norms"]
    med = float(np.median(list(g.values())))
    kept = [k for k, v in g.items() if v >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad_norms"], g, kept)
    change = _leaf_gaps(prog["change_norms"], want["change_norms"], kept)
    rel = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                               want["losses"])]
    worst = max(grad, key=grad.get)
    rows = max(abs(prog["embed_rows"].get(k, 0) - n) / max(n, 1)
               for k, n in want["embed_rows"].items())
    return {"grad_norm_gap_median": float(np.median(list(grad.values()))),
            "embed_rows_gap": rows,
            "change_norm_gap": max(change.values()),
            "grad_norm_gap": grad[worst],
            "grad_worst_leaf": worst,
            "change_norm_gap_median": float(np.median(list(
                change.values()))),
            "loss_rel_first": rel[0], "loss_rel_max": max(rel),
            "leaves_compared": len(kept),
            "leaves_missing": len([k for k in kept
                                   if k not in prog["grad_norms"]])}
