"""host_ms.subpaths: host milliseconds a frame inside the port's span
`subpaths` (`passes/bdpt.bdpt_pass`: the camera and light subpaths and
their extension traces), in `programspans`' stretch with a
`Profiler(wait=False)` active: host clock, no device wait.  A program
without the span gives nothing."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(last="subpaths") if spans else None
