"""scene update: the device time between CUDA events recorded on the
stream before and after Renderer.update_scene, a frame (the refit's graph
and its transform copy)."""


def read(ctx):
    if not ctx.refit_ms:
        return None
    return sum(ctx.refit_ms) / len(ctx.refit_ms)
