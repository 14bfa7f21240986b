"""The attention pair's share of its roofline: the least time of every
attention application the traced iterations make (the configuration's
work counts, ``perfbench.flops.bound_ms`` from each launch's own heads and
widths, whatever kernel computes them) over the device time of the
kernels whose names match a pattern of ``perfbench/kernels/attention/``,
in percent."""

from perfbench.flops import bound_ms


def read(ctx):
    hits = ctx.matching("attention")
    if not hits:
        return None
    spent_ms = sum(end - start for _, start, end in hits) * 1e-6
    least_ms = ctx.iters_traced * sum(
        a.count * bound_ms(a, ctx.bytes_per_s, ctx.peak_flops)
        for a in ctx.applications)
    return 100.0 * least_ms / spent_ms
