"""pass_ms.bmfr: milliseconds of the port's `utils/profiler` event
`frame/bmfr` a frame, in a stretch of `Renderer.render_frame_profiled`
after the traced window (each pass waited for: attribution only)."""


def read(ctx):
    event = ctx.pass_ms.get("frame/bmfr")
    return event["avg_ms"] if event and event["count"] else None
