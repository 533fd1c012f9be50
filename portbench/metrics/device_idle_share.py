"""device_idle_share: the share of a frame in which no device operation
runs, in %: 1 minus the device's busy time a frame (the union of the
profiler's device intervals over the stretch that records the device
alone, over its frames) against the frame time of the run's untraced
window.  Device work a frame does not change under the profiler; the host
that paces the frames does (CUPTI's tracing slows it by up to half), so the
traced stretch's own window would read the profiler's idle time too."""
import devtrace


def read(ctx):
    if not ctx.device or ctx.window[1] <= ctx.window[0] or not ctx.traced_frames \
            or not ctx.frames:
        return None
    w0, w1 = ctx.window
    busy_us = devtrace.busy_us([(max(s, w0), min(e, w1)) for _, s, e in ctx.device
                                if e > w0 and s < w1])
    frame_us = 1e6 * ctx.wall_s / ctx.frames
    return 100.0 * (1.0 - busy_us / ctx.traced_frames / frame_us)
