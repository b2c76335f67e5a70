"""Mean milliseconds of `medplib.stream_prefill` (CLIP, projector, splice,
the prefill into the KV cache, the first token) per call, from the spans
around it in the window of a traced run."""


def read(ctx):
    t = ctx.get("spans", {}).get("stream_prefill")
    return 1e3 * sum(t) / len(t) if t else None
