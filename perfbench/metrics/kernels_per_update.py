"""CUDA kernels in the traced iteration per update step (an update of the
whole stacked state, so the count compares across seed counts); every
kernel of the iteration counts, the act, env and replay kernels too."""


def read(ctx):
    kernels = ctx.trace.kernels() if ctx.trace else []
    if not kernels or not ctx.updates_traced:
        return None
    return len(kernels) / ctx.updates_traced
