"""launches_per_frame: device operations (kernels, copies, sets) the
profiler records a frame in the traced window."""


def read(ctx):
    if not ctx.traced_frames:
        return None
    w0, w1 = ctx.window
    n = sum(1 for _, s, e in ctx.device if s >= w0 and e <= w1)
    return n / ctx.traced_frames if n else None
