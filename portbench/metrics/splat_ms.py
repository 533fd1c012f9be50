"""splat_ms: device milliseconds a frame of the estimator-2 splat: every
device operation from each K2 launch (`compact_kernel`) through the next
K3 launch (`splat_rows_kernel`), the sort between them included."""
import devtrace


def read(ctx):
    us = devtrace.runs_us(ctx.device, ctx.window, "compact_kernel", "splat_rows_kernel")
    if us <= 0 or not ctx.traced_frames:
        return None
    return us / 1e3 / ctx.traced_frames
