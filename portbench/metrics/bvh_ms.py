"""bvh_ms: device milliseconds a frame of the BVH kernels (`csrc/bvh.cu`:
every device operation whose name contains `bvh_`: the closest and any-hit
walks and the shaded kernel's fields pass), in the stretch that records the
device alone."""
import devtrace


def read(ctx):
    us = devtrace.kernel_us(ctx.device, ctx.window, "bvh_")
    if us <= 0 or not ctx.traced_frames:
        return None
    return us / 1e3 / ctx.traced_frames
