"""host_ms.camera: host milliseconds a frame inside the port's `camera`
spans (`Renderer.set_camera_pose`, and `render_frame`'s `camera_moved` and
`begin_frame`), in `programspans`' stretch with a `Profiler(wait=False)`
active: host clock, no device wait."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_ms(last="camera") if spans else None
