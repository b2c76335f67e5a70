"""K4 + K5 + K6 (flash attention forward, dQ, dK / dV) against their
bound: the least time of the profiled steps' flash launches
(portbench/counts.flash_step_bound_s: kept causal pairs at 4·D, 6·D and
8·D FLOP a pair and head, or the bytes) over the three kernels' device
time in the profile, in %."""


def read(ctx):
    k = ctx.get("kernel_s", {})
    t = sum(k.get(i, 0.0) for i in ("K4", "K5", "K6"))
    return 100.0 * ctx["flash_bound_s"] / t if t else None
