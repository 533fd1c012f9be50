"""host_ms.splat: host milliseconds a frame inside the port's `splat`
spans (the est-2 chain of `ops/splat_tile.scatter_add_rgba_tiled_prepacked`:
the keys, K2, the sort and K3, its live-count read included), in
`programspans`' stretch with a `Profiler(wait=False)` active."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(last="splat") if spans else None
