"""host_ms: the host's milliseconds inside `Renderer.render_frame` a
frame, by the benchmark's own spans (host clock, no sync), over the
untraced window.  Moves frame_ms where the host paces the frames."""


def read(ctx):
    spans = ctx.host_frame_s
    return 1e3 * sum(spans) / len(spans) if spans else None
