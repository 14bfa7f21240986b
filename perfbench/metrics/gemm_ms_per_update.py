"""Device ms per update step of the traced kernels whose names match a
pattern of ``perfbench/kernels/gemm/``."""


def read(ctx):
    hits = ctx.matching("gemm")
    if not hits or not ctx.updates_traced:
        return None
    return sum(end - start for _, start, end in hits) * 1e-6 \
        / ctx.updates_traced
