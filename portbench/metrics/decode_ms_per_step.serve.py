"""Milliseconds per decode step: the spans of `medplib.stream_decode_chunk`
in a traced run's window, over the steps they ran (new tokens a call)."""


def read(ctx):
    t = ctx.get("spans", {}).get("stream_decode_chunk")
    return 1e3 * sum(t) / (len(t) * ctx["new_tokens"]) if t else None
