"""host_ms.bmfr: host milliseconds a frame inside the port's span
`frame/bmfr` with no device wait (a `Profiler(wait=False)` active in
`programspans`' stretch): the host's share of BMFR, which `pass_ms.bmfr`
reads with a wait after each pass."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(path="frame/bmfr") if spans else None
