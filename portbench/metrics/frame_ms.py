"""frame_ms: the window's wall time (host clock, one sync at its end) over
the frames completed in it."""


def read(ctx):
    return 1e3 * ctx.wall_s / ctx.frames if ctx.frames else None
