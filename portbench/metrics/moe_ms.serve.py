"""Device milliseconds a call under the program's `moe.route`,
`moe.experts` and `moe.shared` spans (routing, the routed experts on K1 /
K2 with their gathers and combine, the shared experts), from the profiled
calls of a traced run, put down to spans by `profiling.span_summary`."""

NAMES = ("moe.route", "moe.experts", "moe.shared")


def read(ctx):
    spans = (ctx.get("program") or {}).get("spans", {})
    found = [spans[n]["device_s"] for n in NAMES if n in spans]
    return 1e3 * sum(found) / ctx["profile_calls"] if found else None
