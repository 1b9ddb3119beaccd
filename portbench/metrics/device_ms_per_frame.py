"""device: the union of the device's activity over the profiled span, per
profiled frame."""


def read(ctx):
    if not ctx.frames or ctx.busy_ns <= 0:
        return None
    return ctx.busy_ns / 1e6 / len(ctx.frames)
