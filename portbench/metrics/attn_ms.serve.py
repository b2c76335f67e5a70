"""Device milliseconds a call under the program's `attn` spans (the
attention of every decoder layer, prefill and decode: projections, the
latent compression, expansion or absorption, the cache write, the
attention core), from the profiled calls of a traced run, put down to
spans by `profiling.span_summary`."""


def read(ctx):
    spans = (ctx.get("program") or {}).get("spans", {})
    s = spans.get("attn")
    return 1e3 * s["device_s"] / ctx["profile_calls"] if s else None
