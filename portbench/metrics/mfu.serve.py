"""The whole call's share of the card's bf16 dense peak: the operations
the window's calls need (portbench/counts.serve_call_flops: CLIP, the
projector, the decoder with one expert a token, lm_head, SAM) over the
seconds those calls took, in %."""

from portbench import counts


def read(ctx):
    wall = ctx.get("timed_wall_s")
    if not wall:
        return None
    return 100.0 * ctx["timed_flops"] / wall / counts.BF16_FLOPS
