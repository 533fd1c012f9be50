"""sync_ms: host milliseconds a frame inside the port's `read_*` spans,
the reads of a device value on the host (`splat/read_live`), where the
host waits for the device; in `programspans`' stretch with a
`Profiler(wait=False)` active."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(prefix="read_") if spans else None
