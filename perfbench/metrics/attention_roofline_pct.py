"""The attention pair's share of its roofline: the least time of every
attention application the traced iterations make (counted from the
model's shapes, ``perfbench.flops``, whatever kernel computes them) over
the device time of the kernels whose names match a pattern of
``perfbench/kernels/attention/``, in percent."""

from perfbench.flops import bound_ms


def read(ctx):
    hits = ctx.matching("attention")
    if not hits:
        return None
    spent_ms = sum(end - start for _, start, end in hits) * 1e-6
    least_ms = ctx.iters_traced * sum(
        a.count * bound_ms(a.kind, a.batch, a.lq, a.lk, ctx.heads,
                           ctx.head_dim, a.causal, ctx.bytes_per_s,
                           ctx.peak_flops)
        for a in ctx.applications)
    return 100.0 * least_ms / spent_ms
