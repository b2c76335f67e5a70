"""Driver: a closed loop of grounded-answer batches through
`models/medplib.generate` (ground=True), the serving entry of the port.

Set-up builds the configuration's serving tree from the seed (bf16 draws
on the card, then the port's own quantization: int8 everywhere it
quantizes, the experts padded and int4h layer by layer, the order of the
flagship's serving build) and runs one call on a batch of the cell's
shapes. The window then sends batch after batch, each the moment the last
one's tokens and masks are back on the host, and closes when the call in
flight at the deadline returns: the rate is every completed answer over
all that time. A traced run spans the three public functions `generate`
is made of and profiles the calls after the deadline.

After the window the tree is freed and the plain reference works out the
calls drawn from the seed again (portbench/reference/serve.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts, traffic, tracing, weights

SPANNED = ("stream_prefill", "stream_decode_chunk", "ground_seg_slots")


def port_config(model: dict):
    """The configuration file -> the port's MedplibConfig."""
    from medplib_tpu_torch.config import (ClipVisionConfig, LlamaConfig,
                                          MedplibConfig, MoeConfig,
                                          ProjectorConfig, SamConfig,
                                          SegConfig)
    med = model["medplib"]
    llm = LlamaConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        intermediate_size=model["intermediate_size"],
        num_layers=model["num_hidden_layers"],
        num_heads=model["num_attention_heads"],
        num_kv_heads=model["num_key_value_heads"],
        head_dim=model["head_dim"], rope_theta=model["rope_theta"],
        rms_norm_eps=model["rms_norm_eps"],
        max_position_embeddings=model["max_position_embeddings"],
        tie_word_embeddings=model["tie_word_embeddings"])
    sam = dict(med["sam"])
    sam["encoder_global_attn_indexes"] = tuple(
        sam["encoder_global_attn_indexes"])
    return MedplibConfig(
        llm=llm, vision=ClipVisionConfig(**med["vision"]),
        sam=SamConfig(**sam),
        projector=ProjectorConfig(hidden_size=model["hidden_size"],
                                  **med["projector"]),
        moe=MoeConfig(enable=True, **med["moe"]),
        seg=SegConfig(**med["seg"]), seg_token_idx=med["seg_token_idx"],
        vocab_size_padded=med["vocab_size_padded"])


def _materialize(node, path: str, seed: int, device):
    """A tree of meta tensors (the port's layout) -> the seeded weights."""
    if isinstance(node, dict):
        return {k: _materialize(v, f"{path}/{k}" if path else k, seed,
                                device) for k, v in node.items()}
    if isinstance(node, list):
        return [_materialize(v, f"{path}/{i}", seed, device)
                for i, v in enumerate(node)]
    shape = tuple(node.shape)
    if not weights.is_stacked(path):
        return weights.draw(seed, path, shape, device)
    out = torch.empty(shape, dtype=torch.bfloat16, device=device)
    for i in range(shape[0]):
        out[i] = weights.draw(seed, path, shape[1:], device, layer=i)
    return out


def build_params(cfg, model: dict, seed: int, device):
    """The serving tree: the dense skeleton without the dense MLP, int8;
    then per layer the experts drawn, padded and quantized int4h (so the
    bf16 expert stacks never exist whole), and the routers."""
    from medplib_tpu_torch.config import MoeConfig
    from medplib_tpu_torch.models import medplib, moe_llama
    from medplib_tpu_torch.utils import quantize as qz
    srv = model["serving"]
    skel = medplib.init_medplib(torch.Generator(), dataclasses.replace(
        cfg, moe=MoeConfig()), torch.bfloat16, "meta")
    skel["llm"] = moe_llama.strip_dense_mlp(skel["llm"], cfg.llm, cfg.moe)
    params = _materialize(skel, "", seed, device)
    del skel
    params = qz.quantize_tree(params, bits=srv["attn_bits"])
    L, E = cfg.llm.num_layers, cfg.moe.num_experts
    H, M = cfg.llm.hidden_size, cfg.llm.intermediate_size
    shapes = {"gate_proj": (E, H, M), "up_proj": (E, H, M),
              "down_proj": (E, M, H)}
    skey = "scale4h" if srv["expert_bits"] == 4 else "scale"
    nodes = {n: {"kernel": [], skey: []} for n in shapes}
    base = "llm/layers/moe/experts"
    for i in range(L):
        one = {n: {"kernel": weights.draw(seed, f"{base}/{n}/kernel", s,
                                          device, layer=i)}
               for n, s in shapes.items()}
        one = qz.pad_moe_experts_for_gmm(one, srv["expert_pad_align"])
        one = qz.quantize_tree(one, skip=(), bits=srv["expert_bits"],
                               int4_groups=srv["expert_int4_groups"])
        for n in nodes:
            for k in nodes[n]:
                nodes[n][k].append(one[n][k])
        del one
    experts = {n: {k: torch.stack(v) for k, v in node.items()}
               for n, node in nodes.items()}
    router = torch.empty((L, H, E), dtype=torch.bfloat16, device=device)
    for i in range(L):
        router[i] = weights.draw(seed, "llm/layers/moe/router/kernel",
                                 (H, E), device, layer=i)
    params["llm"]["layers"]["moe"] = {"router": {"kernel": router},
                                      "experts": experts}
    dtype = getattr(torch, srv["dtype"])
    return params if dtype == torch.bfloat16 else _cast(params, dtype)


def _cast(node, dtype):
    """Every bf16 leaf to `dtype` (a configuration served in another
    float type; integer weights and their f32 scales stay)."""
    if isinstance(node, dict):
        return {k: _cast(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast(v, dtype) for v in node]
    return node.to(dtype) if node.dtype == torch.bfloat16 else node


class Driver:
    def __init__(self, model: dict, mix: dict, cell: dict, seed: int,
                 device):
        self.model, self.mix, self.cell = model, mix, cell
        self.seed, self.device = seed, torch.device(device)
        self.outputs: List[Dict] = []

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        if self.device.type == "cuda":
            from medplib_tpu_torch.ops.cuda import _build
            _build.load_library()
        self.cfg = port_config(self.model)
        self.params = build_params(self.cfg, self.model, self.seed,
                                   self.device)
        self._call(-1)                        # every shape of the cell
        tracing.sync(self.device)

    def _batch(self, call: int):
        from medplib_tpu_torch.models.medplib import Batch
        b = traffic.make(self.mix, self.model, self.seed, call, self.device)
        n = b["ids"].shape[0]
        n_img = self.cfg.vision.num_patches
        batch = Batch.make(
            input_ids=b["ids"], input_mask=b["mask"], labels=b["ids"],
            images_clip=b["clip"], images_sam=b["sam"],
            image_token_lengths=torch.full((n, 1), n_img, dtype=torch.int32,
                                           device=self.device),
            sam_frame=self.cfg.sam.image_size)
        return b, batch

    def _call(self, call: int) -> Dict:
        """One request batch, answered back to the host."""
        from medplib_tpu_torch.models import medplib
        from medplib_tpu_torch.utils.quantize import dynamic_act_quant
        b, batch = self._batch(call)
        with dynamic_act_quant(self.model["serving"]["act_quant"]):
            r = medplib.generate(self.params, self.cfg, batch,
                                 max_new_tokens=b["new_tokens"],
                                 eos_id=self.model["eos_token_id"],
                                 ground=True, max_segs=1)
        n_img = self.cfg.vision.num_patches
        b_rows, t_in = b["ids"].shape
        return {"call": call, "ids": r.output_ids.cpu().numpy(),
                "masks": r.pred_masks.float().cpu(),
                "rows": b_rows * (t_in - 1 + n_img),    # spliced, padded
                "prompt_lens": [int(n) - 1 + n_img for n in b["lens"]],
                "new_tokens": b["new_tokens"]}

    def _flops(self, out: Dict) -> float:
        return counts.serve_call_flops(self.model, out["prompt_lens"],
                                       out["new_tokens"])

    # -- the window -----------------------------------------------------
    def window(self, seconds: float, trace: bool) -> Dict:
        from medplib_tpu_torch.models import medplib
        spans = tracing.Spans(self.device)
        walls: List[float] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        call = 0
        scope = (spans.around(medplib, SPANNED) if trace
                 else contextlib.nullcontext())
        with scope:
            while time.perf_counter() < deadline:
                c0 = time.perf_counter()
                self.outputs.append(self._call(call))
                walls.append(time.perf_counter() - c0)
                call += 1
        t1 = time.perf_counter()
        answers = sum(o["ids"].shape[0] for o in self.outputs)
        ctx = {"model": self.model, "window_s": t1 - t0,
               "answers": answers, "calls": len(self.outputs),
               "masks_per_s": answers / (t1 - t0)}
        if trace:
            ctx.update(self._traced(spans, walls, call))
        return ctx

    def _traced(self, spans, walls, call) -> Dict:
        """Per-layer readings: the spans of the window's calls, then a
        device profile of `profile_calls` more."""
        from medplib_tpu_torch.models import medplib
        from medplib_tpu_torch.ops.cuda import gmm as G
        from medplib_tpu_torch.ops.cuda import moe_decode as D
        timed = list(self.outputs)
        n_prof = self.cell["profile_calls"]
        k1_0, k2_0 = G.gmm_int4h.launches, D.moe_ffn_decode_int4h.launches
        tracing.sync(self.device)
        with spans.around(medplib, SPANNED), \
                tracing.profile(self.device) as prof:
            p0 = time.perf_counter()
            prof_out = [self._call(call + j) for j in range(n_prof)]
            tracing.sync(self.device)
            p_wall = time.perf_counter() - p0
        summary = tracing.summarize(prof)
        rows = sum(o["rows"] for o in prof_out)
        steps = [(o["ids"].shape[0], o["new_tokens"]) for o in prof_out]
        return {
            "spans": dict(spans.times),
            "timed_flops": sum(self._flops(o) for o in timed),
            "timed_wall_s": sum(walls),
            "profile": summary,
            "profile_wall_s": p_wall,
            "kernel_s": counts.by_kernel_id(summary["ops"]),
            "k1_bound_s": sum(counts.k1_bound_s(self.model, o["rows"])
                              for o in prof_out),
            "k2_bound_s": sum(counts.k2_bound_s(self.model, b, n)
                              for b, n in steps),
            "launches": {"K1": G.gmm_int4h.launches - k1_0,
                         "K2": D.moe_ffn_decode_int4h.launches - k2_0},
            "profiled_rows": rows,
            "new_tokens": self.mix["new_tokens"],
        }

    # -- the comparison -------------------------------------------------
    def release(self) -> None:
        del self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check_calls(self) -> List[int]:
        """The calls compared: `check_calls` of the finished ones, drawn
        from the seed (every call holds the mix's longest row)."""
        n = len(self.outputs)
        k = min(self.cell["check_calls"], n)
        rng = np.random.default_rng(weights.key_of(self.seed, "check"))
        return sorted(int(i) for i in rng.choice(n, size=k, replace=False))

    def _reference(self, picked, bits: int) -> Dict:
        from portbench.reference import serve
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return serve.run(self.model, self.mix, self.seed,
                         [o["call"] for o in picked],
                         [o["ids"] for o in picked], self.device, bits)

    def check(self) -> Dict[str, float]:
        from portbench.reference import serve
        picked = [self.outputs[i] for i in self.check_calls()]
        want = self._reference(picked, self.model["serving"]["attn_bits"])
        return serve.readings(want, serve.program_masks(
            [o["masks"] for o in picked], self.device))

    def readings_with_control(self):
        """The program's readings over `check_calls` calls of the cell's
        batch, and the control's (int4 for the int8 linears) over the same
        prompts and tokens; the tree is freed first."""
        from portbench.reference import serve
        for call in range(self.cell["check_calls"]):
            self.outputs.append(self._call(call))
        self.release()
        want = self._reference(self.outputs,
                               self.model["serving"]["attn_bits"])
        prog = serve.readings(want, serve.program_masks(
            [o["masks"] for o in self.outputs], self.device))
        return prog, serve.control_readings(want,
                                            self._reference(self.outputs, 4))

