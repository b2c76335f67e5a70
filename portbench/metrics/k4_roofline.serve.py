"""K4 at q / k 192, v 128 (`flash_fwd_mma_kernel<192, 128>`, the expanded
latent attention of a DeepSeek-V2 prefill) against its bound: the least
time of the profiled calls' launches (portbench/counts_dsv2.k4_bound_s:
the kept pairs' operations at the bf16 peak or the q, k, v, out bytes at
the HBM rate) over that instantiation's device time in the profile, in
%."""


def read(ctx):
    t = ctx.get("k4_192_s")
    return 100.0 * ctx["k4_192_bound_s"] / t if t else None
