"""device: the share of the profiled span's steady part (from the end of
its first frame's dispatch to its last device activity) in which no
kernel, copy or fill ran on the card."""


def read(ctx):
    if ctx.span_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.steady_busy_ns / ctx.span_ns)
