"""host_ms.shadows: host milliseconds a frame inside the port's span
`shadows` (`passes/bdpt.bdpt_pass`: the shadow batches of estimators 1-3,
built and traced through its `shadow_fn`), in `programspans`' stretch with
a `Profiler(wait=False)` active: host clock, no device wait.  A program
without the span gives nothing."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(last="shadows") if spans else None
