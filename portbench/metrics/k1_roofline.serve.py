"""K1 (`gmm_int4h`, W4A8 grouped experts at prefill) against its bound:
the least time of the profiled calls' K1 work (portbench/counts.k1_bound_s:
the routed rows' operations at the int8 peak) over K1's device time in the
profile, in %."""


def read(ctx):
    t = ctx.get("kernel_s", {}).get("K1")
    return 100.0 * ctx["k1_bound_s"] / t if t else None
