"""Reduction of a `torch.profiler` trace to what the metrics read.

`collect(prof)` splits the profiler's events into device operations
(kernels, copies, sets: name, start and end in microseconds) and host
events (the benchmark's `record_function` spans and the operators under
them).  `busy_us` is the length of the union of intervals; `idle_gaps`
lists the gaps between device operations inside a window and names each by
the innermost host event under way at its middle; `top_ops` sums device
time by name.
"""
from __future__ import annotations

from collections import defaultdict


def collect(prof, annotation_prefix: str = "portbench."):
    """(device ops, host events): lists of (name, start_us, end_us).  The
    device timeline's copies of `record_function` ranges (user annotations)
    are no device operations and are left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(annotation_prefix)):
                device.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    device.sort(key=lambda s: s[1])
    return device, host


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def idle_gaps(device, window, min_us: float = 0.0):
    """[(start, end)] of the window (start, end) in which no device
    operation runs."""
    w0, w1 = window
    gaps, cursor = [], w0
    for _, s, e in device:
        if e <= w0 or s >= w1:
            continue
        if s > cursor and s - cursor > min_us:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    return gaps


def name_gaps(gaps, host):
    """Idle seconds by the innermost host event under way at each gap's
    middle ('(none)' where none is), largest first.  Host events of one
    thread nest, so the innermost is the latest-started one still open: a
    sweep with a stack."""
    events = sorted(host, key=lambda h: (h[1], -h[2]))
    mids = sorted(((0.5 * (g0 + g1), g1 - g0) for g0, g1 in gaps))
    by_name = defaultdict(float)
    stack, k = [], 0
    for mid, length in mids:
        while k < len(events) and events[k][1] <= mid:
            while stack and stack[-1][2] < events[k][1]:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        by_name[stack[-1][0] if stack else "(none)"] += length / 1e6
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def top_ops(device, window):
    """Device seconds by operation name inside the window, largest first."""
    w0, w1 = window
    by_name = defaultdict(float)
    for name, s, e in device:
        if s >= w0 and e <= w1:
            by_name[name] += (e - s) / 1e6
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def kernel_us(device, window, match) -> float:
    """Device microseconds of the operations whose name contains `match`."""
    w0, w1 = window
    return sum(e - s for name, s, e in device if match in name and s >= w0 and e <= w1)


def runs_us(device, window, first: str, last: str) -> float:
    """Device microseconds of every operation from each one named like
    `first` through the next named like `last` (the splat's K2, sort, K3)."""
    w0, w1 = window
    total, start = 0.0, None
    inside = [d for d in device if d[1] >= w0 and d[2] <= w1]
    for k, (name, s, e) in enumerate(inside):
        if first in name:
            start = k
        if last in name and start is not None:
            total += busy_us([(x[1], x[2]) for x in inside[start:k + 1]])
            start = None
    return total
