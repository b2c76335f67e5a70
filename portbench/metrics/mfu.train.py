"""The whole training step's share of the card's bf16 dense peak: the
operations the window's steps need (portbench/counts.train_step_flops:
forward, input gradients through the frozen decoder, trainable weights'
gradients; no recomputation) over the seconds those steps took, in %."""

from portbench import counts


def read(ctx):
    wall = ctx.get("timed_wall_s")
    if not wall:
        return None
    return 100.0 * ctx["timed_flops"] / wall / counts.BF16_FLOPS
