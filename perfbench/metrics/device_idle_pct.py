"""The share of the traced chunk (its launch to its sync's end) that no
device operation covers (the union of their intervals), in percent."""


def read(ctx):
    trace = ctx.chunk_trace
    if trace is None or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
