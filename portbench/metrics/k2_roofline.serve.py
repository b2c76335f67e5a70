"""K2 (the fused int4h MoE decode, its five kernels) against its bound:
the least time of the profiled calls' decode steps (portbench/counts.
k2_bound_s: the routed experts' weight bytes at the HBM rate) over K2's
device time in the profile, in %."""


def read(ctx):
    t = ctx.get("kernel_s", {}).get("K2")
    return 100.0 * ctx["k2_bound_s"] / t if t else None
