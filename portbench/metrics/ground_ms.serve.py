"""Mean milliseconds of `medplib.ground_seg_slots` (SAM's image encoder and
the mask decoder over each row's <SEG> slot) per call, from the spans of a
traced run's window."""


def read(ctx):
    t = ctx.get("spans", {}).get("ground_seg_slots")
    return 1e3 * sum(t) / len(t) if t else None
