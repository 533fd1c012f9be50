"""device_ms.bmfr: device milliseconds a frame of the operations launched
inside the port's span `frame/bmfr`, from a stretch under `torch.profiler`
recording the host and the device (`programspans`: each operation is
charged to the spans open around the operator that launched it), with no
device wait."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.device_ms("frame/bmfr") if spans else None
