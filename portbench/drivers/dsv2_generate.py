"""Driver: generate_batch's closed loop of grounded-answer batches through
`models/medplib.generate` for a DeepSeek-V2 configuration (multi-head
latent attention over a latent cache, top-k fine-grained MoE with shared
experts, a dense leading layer).

Set-up builds the tree from the seed (bf16 draws on the card: the MLA
and MLP stacks one layer at a time, by absolute layer index; int8
everywhere the configuration quantizes; the routed experts drawn, padded
and quantized int4h layer by layer) and runs one call on a batch of the
cell's shapes. The window is generate_batch's. A traced run also
profiles its calls under the program's `profiling.recording()`, so that
the metrics read the program's spans (`span_summary`), and counts the
launches of K1, K2 and K4 at q / k 192, v 128, the plain attention's
calls, the latent cache's bytes a call and the (k, E) of the routes.

After the window the plain reference (portbench/reference/serve_dsv2.py)
works out the compared calls again.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from portbench import counts, counts_dsv2, tracing, weights
from portbench.drivers import generate_batch as gb


def port_config(model: dict):
    """The configuration file -> the port's MedplibConfig (MlaConfig +
    DeepseekMoeConfig)."""
    from medplib_tpu_torch.config import (ClipVisionConfig,
                                          DeepseekMoeConfig, MedplibConfig,
                                          MlaConfig, ProjectorConfig,
                                          SamConfig, SegConfig, YarnScaling)
    med = model["medplib"]
    rs = model.get("rope_scaling")
    yarn = None
    if rs:
        if rs.get("type") != "yarn":
            raise ValueError(f"rope_scaling {rs.get('type')!r} is not YaRN")
        yarn = YarnScaling(**{k: v for k, v in rs.items() if k != "type"})
    if model["q_lora_rank"] is not None or model["topk_method"] != "greedy":
        raise ValueError("the port's MLA takes q_lora_rank null and greedy "
                         "top-k routing")
    llm = MlaConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        intermediate_size=model["intermediate_size"],
        num_layers=model["num_hidden_layers"],
        num_heads=model["num_attention_heads"],
        num_kv_heads=model["num_key_value_heads"],
        head_dim=model["qk_nope_head_dim"] + model["qk_rope_head_dim"],
        rope_theta=float(model["rope_theta"]),
        rms_norm_eps=model["rms_norm_eps"],
        max_position_embeddings=model["max_position_embeddings"],
        tie_word_embeddings=model["tie_word_embeddings"],
        kv_lora_rank=model["kv_lora_rank"],
        qk_nope_head_dim=model["qk_nope_head_dim"],
        qk_rope_head_dim=model["qk_rope_head_dim"],
        v_head_dim=model["v_head_dim"], rope_scaling=yarn)
    moe = DeepseekMoeConfig(
        enable=True, num_experts=model["n_routed_experts"],
        top_k=model["num_experts_per_tok"],
        moe_intermediate_size=model["moe_intermediate_size"],
        num_shared_experts=model["n_shared_experts"],
        first_k_dense_replace=model["first_k_dense_replace"],
        norm_topk_prob=model["norm_topk_prob"],
        routed_scaling_factor=float(model["routed_scaling_factor"]))
    sam = dict(med["sam"])
    sam["encoder_global_attn_indexes"] = tuple(
        sam["encoder_global_attn_indexes"])
    return MedplibConfig(
        llm=llm, vision=ClipVisionConfig(**med["vision"]),
        sam=SamConfig(**sam),
        projector=ProjectorConfig(hidden_size=model["hidden_size"],
                                  **med["projector"]),
        moe=moe, seg=SegConfig(**med["seg"]),
        seg_token_idx=med["seg_token_idx"],
        vocab_size_padded=med["vocab_size_padded"])


def _draw_stack(seed: int, path: str, shape, first: int, device):
    """A stacked leaf [n, ...] whose slice j is layer first + j."""
    out = torch.empty(tuple(shape), dtype=torch.bfloat16, device=device)
    for j in range(shape[0]):
        out[j] = weights.draw(seed, path, shape[1:], device, layer=first + j)
    return out


def _draw_tree(node, path: str, seed: int, first: int, device):
    if isinstance(node, dict):
        return {k: _draw_tree(v, f"{path}/{k}", seed, first, device)
                for k, v in node.items()}
    return _draw_stack(seed, path, node.shape, first, device)


def build_params(cfg, model: dict, seed: int, device):
    """The serving tree: everything but the routed experts drawn and
    stored int8; then per MoE layer its experts drawn, padded and
    quantized int4h (the bf16 expert stacks never exist whole)."""
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils import quantize as qz
    srv = model["serving"]
    kd = cfg.moe.first_k_dense_replace
    skel = medplib.init_medplib(torch.Generator(), cfg, torch.bfloat16,
                                "meta")
    llm = skel["llm"]
    dense, moe = llm.pop("dense_mlp"), llm.pop("moe")
    experts = moe.pop("experts")
    params = gb._materialize(skel, "", seed, device)
    params["llm"]["dense_mlp"] = _draw_tree(dense, "llm/dense_mlp", seed, 0,
                                            device)
    params["llm"]["moe"] = _draw_tree(moe, "llm/moe", seed, kd, device)
    del skel
    params = qz.quantize_tree(params, bits=srv["attn_bits"])
    skey = "scale4h" if srv["expert_bits"] == 4 else "scale"
    nodes = {n: {"kernel": [], skey: []} for n in experts}
    base = "llm/moe/experts"
    for j in range(experts["gate_proj"]["kernel"].shape[0]):
        one = {n: {"kernel": weights.draw(seed, f"{base}/{n}/kernel",
                                          experts[n]["kernel"].shape[1:],
                                          device, layer=kd + j)}
               for n in experts}
        one = qz.pad_moe_experts_for_gmm(one, srv["expert_pad_align"])
        one = qz.quantize_tree(one, skip=(), bits=srv["expert_bits"],
                               int4_groups=srv["expert_int4_groups"])
        for n in nodes:
            for k in nodes[n]:
                nodes[n][k].append(one[n][k])
        del one
    params["llm"]["moe"]["experts"] = {
        n: {k: torch.stack(v) for k, v in node.items()}
        for n, node in nodes.items()}
    return params


class Driver(gb.Driver):
    def setup(self) -> None:
        self.cfg = port_config(self.model)    # before the kernels build
        if self.device.type == "cuda":
            from medplib_tpu_torch.ops.cuda import _build
            _build.load_library()
        self.params = build_params(self.cfg, self.model, self.seed,
                                   self.device)
        self._call(-1)                        # every shape of the cell
        tracing.sync(self.device)

    def _flops(self, out: Dict) -> float:
        return counts_dsv2.serve_call_flops(self.model, out["prompt_lens"],
                                            out["new_tokens"])

    def _traced(self, spans, walls, call) -> Dict:
        """generate_batch's readings, the profiled calls also under the
        program's recording: its spans' device time (`program`), and the
        launches and bytes the result line reports. On the card the
        launches must be counts_dsv2.launches_per_call's, or it raises."""
        from medplib_tpu_torch.models import medplib
        from medplib_tpu_torch.models.mla import LatentCache
        from medplib_tpu_torch.ops.attention import causal_attention
        from medplib_tpu_torch.ops.cuda import gmm as G
        from medplib_tpu_torch.ops.cuda import moe_decode as D
        from medplib_tpu_torch.ops.cuda.flash_attention import flash_forward
        from medplib_tpu_torch.utils import profiling
        timed = list(self.outputs)
        n_prof = self.cell["profile_calls"]
        before = (G.gmm_int4h.launches, D.moe_ffn_decode_int4h.launches,
                  flash_forward.launches_qk192, causal_attention.plain_calls,
                  LatentCache.allocated_bytes)
        tracing.sync(self.device)
        with profiling.recording() as rec, \
                spans.around(medplib, gb.SPANNED), \
                tracing.profile(self.device) as prof:
            p0 = time.perf_counter()
            prof_out = [self._call(call + j) for j in range(n_prof)]
            tracing.sync(self.device)
            p_wall = time.perf_counter() - p0
        after = (G.gmm_int4h.launches, D.moe_ffn_decode_int4h.launches,
                 flash_forward.launches_qk192, causal_attention.plain_calls,
                 LatentCache.allocated_bytes)
        summary = tracing.summarize(prof)
        rows = sum(o["rows"] for o in prof_out)
        steps = [(o["ids"].shape[0], o["new_tokens"]) for o in prof_out]
        k4 = [counts_dsv2.k4_bound_s(self.model, o["prompt_lens"],
                                     o["rows"] // o["ids"].shape[0])[0]
              for o in prof_out]
        d = [a - b for a, b in zip(after, before)]
        routes = sorted({(r.attrs.get("k"), r.attrs.get("E"))
                         for r in rec.records if r.name == "moe.route"})
        launches = {"K1": d[0], "K2": d[1], "K4_qk192": d[2],
                    "plain_attention": d[3]}
        if self.device.type == "cuda":     # the kernels launch on the card
            want = {n: sum(counts_dsv2.launches_per_call(self.model, b, s)[n]
                           for b, s in steps) for n in launches}
            if launches != want:
                raise RuntimeError(f"traced launches {launches} are not the "
                                   f"counts file's {want}")
        return {
            "spans": dict(spans.times),
            "timed_flops": sum(self._flops(o) for o in timed),
            "timed_wall_s": sum(walls),
            "profile": summary,
            "profile_wall_s": p_wall,
            "profile_calls": n_prof,
            "program": profiling.span_summary(prof, rec),
            "kernel_s": counts.by_kernel_id(summary["ops"]),
            "k1_bound_s": sum(counts_dsv2.k1_bound_s(self.model, o["rows"])
                              for o in prof_out),
            "k2_bound_s": sum(counts_dsv2.k2_bound_s(self.model, b, n)
                              for b, n in steps),
            "k4_192_s": counts_dsv2.k4_192_s(summary["ops"]),
            "k4_192_bound_s": sum(k4),
            "launches": {**launches,
                         "latent_cache_bytes_per_call": d[4] // n_prof,
                         "moe_route_k_E": [list(r) for r in routes]},
            "profiled_rows": rows,
            "new_tokens": self.mix["new_tokens"],
        }

    # -- the comparison -------------------------------------------------
    def _reference(self, picked, bits: int) -> Dict:
        from portbench.reference import serve_dsv2
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return serve_dsv2.run(self.model, self.mix, self.seed,
                              [o["call"] for o in picked],
                              [o["ids"] for o in picked], self.device, bits)

    def readings_with_control(self):
        """The program's readings over `check_calls` calls, and two
        controls' over the same prompts: the reference with the int8
        linears in int4 (on the program's tokens), and the program with
        the YaRN mscale^2 left out of its softmax scale (its own tokens
        and masks, compared as the program's are)."""
        from medplib_tpu_torch.models import mla
        from portbench.reference import serve
        n = self.cell["check_calls"]
        progs: List[Dict] = [self._call(c) for c in range(n)]
        plain_scale = self.cfg.llm.q_head_dim ** -0.5
        saved = mla.mla_softmax_scale
        mla.mla_softmax_scale = lambda cfg: plain_scale
        try:
            unscaled = [self._call(c) for c in range(n)]
        finally:
            mla.mla_softmax_scale = saved
        self.release()
        bits = self.model["serving"]["attn_bits"]
        want = self._reference(progs, bits)
        prog = serve.readings(want, serve.program_masks(
            [o["masks"] for o in progs], self.device))
        int4 = serve.control_readings(want, self._reference(progs, 4))
        want_u = self._reference(unscaled, bits)
        scale = serve.readings(want_u, serve.program_masks(
            [o["masks"] for o in unscaled], self.device))
        return prog, {"int4_linears": int4, "no_mscale": scale}

