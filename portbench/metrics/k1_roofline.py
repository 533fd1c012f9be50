"""k1_roofline: K1's least time by its bytes (peaks.k1_frame_bytes) over
its device time a frame (kernels named `frame_kernel`), in %."""
import devtrace
import peaks


def read(ctx):
    us = devtrace.kernel_us(ctx.device, ctx.window, "frame_kernel")
    if us <= 0 or not ctx.traced_frames:
        return None
    need = peaks.k1_frame_bytes(ctx.width, ctx.height, ctx.depth, ctx.n_tris, ctx.n_lights)
    bound_ms = peaks.bound(need, 0.0)["bound_ms"]
    return 100.0 * bound_ms * ctx.traced_frames / (us / 1e3)
