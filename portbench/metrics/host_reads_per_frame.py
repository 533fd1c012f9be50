"""host_reads_per_frame: the port's count of reads of a CUDA tensor's
value on the host (`cuda.READS["host_reads"]`, each a wait for the
device) over the frames of `programspans`' stretch."""
import programspans


def read(ctx):
    spans = programspans.of(ctx)
    return spans.host_reads / spans.frames if spans and spans.frames else None
