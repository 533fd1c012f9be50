"""The trace reduction on synthetic intervals."""
import devtrace

DEVICE = [("k1", 0.0, 10.0), ("compact_kernel<x>", 20.0, 30.0), ("sort", 25.0, 40.0),
          ("splat_rows_kernel<y>", 45.0, 50.0), ("k1", 100.0, 110.0)]


def test_busy_union_counts_overlaps_once():
    assert devtrace.busy_us([(s, e) for _, s, e in DEVICE]) == 10 + 20 + 5 + 10
    assert devtrace.busy_us([]) == 0.0
    assert devtrace.busy_us([(0, 10), (2, 3), (5, 12)]) == 12


def test_idle_gaps_and_their_names():
    gaps = devtrace.idle_gaps(DEVICE, (0.0, 120.0))
    assert gaps == [(10.0, 20.0), (40.0, 45.0), (50.0, 100.0), (110.0, 120.0)]
    idle = sum(b - a for a, b in gaps)
    assert idle + devtrace.busy_us([(s, e) for _, s, e in DEVICE]) == 120.0
    host = [("frame", 0.0, 115.0), ("aten::item", 55.0, 99.0), ("wait", 110.0, 120.0)]
    named = dict(devtrace.name_gaps(gaps, host))
    assert abs(named["aten::item"] - 50e-6) < 1e-12
    assert abs(named["frame"] - 15e-6) < 1e-12 and abs(named["wait"] - 10e-6) < 1e-12


def test_splat_runs_and_kernel_sums():
    assert devtrace.runs_us(DEVICE, (0.0, 120.0), "compact_kernel", "splat_rows_kernel") == 25.0
    assert devtrace.kernel_us(DEVICE, (0.0, 120.0), "k1") == 20.0
    assert devtrace.top_ops(DEVICE, (0.0, 60.0))[0] == ("sort", 15e-6)
