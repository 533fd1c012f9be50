"""setup_s: from the process's start to the first timed frame: imports,
the kernel library (built on a checkout's first run), the scene's bake on
the card and the warm-up frames."""


def read(ctx):
    return ctx.setup_s
