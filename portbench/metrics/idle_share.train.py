"""Share of the profiled steps' wall time in which no operation ran on the
card (torch.profiler's CUDA activity, merged), in %."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not ctx.get("profile_wall_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / ctx["profile_wall_s"])
