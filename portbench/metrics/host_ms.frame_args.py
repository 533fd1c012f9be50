"""host_ms.frame_args: host milliseconds a frame inside the port's span
`frame/megakernel/frame_args` (K1's argument packing,
`accel/frame.frame_args`), in `programspans`' stretch with a
`Profiler(wait=False)` active: host clock, no device wait."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(path="frame/megakernel/frame_args") if spans else None
