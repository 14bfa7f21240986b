"""The whole step's share of the card's peak in the configuration's
precision: the model FLOPs of the measured window's iterations
(the configuration's work counts, from shapes, no recomputation) over
the window's wall time times the peak, in percent."""


def read(ctx):
    if not ctx.window_s or not ctx.peak_flops:
        return None
    return 100.0 * ctx.flops_per_iter * ctx.iters_window / (
        ctx.window_s * ctx.peak_flops)
