"""frame_ms_p95: the 95th percentile, over every frame of the window, of
a frame's latency: from the host starting to enqueue it (its pose) to its
CUDA event after `Renderer.display`, on the host clock through an event
recorded at the window's start."""
import statistics


def read(ctx):
    lat = ctx.latencies_s
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
