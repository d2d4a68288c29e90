"""Reduce a profiler trace to device busy time, stage device time, the
heaviest device operations and the idle gaps named by the host range open
at the time.

Input is two lists of ``(name, start_us, end_us)`` on the profiler's
clock: host ranges (the program's spans, opened as profiler ranges, and
the harness's own ranges) and device activities (kernels, copies, sets).
A device activity belongs to a stage when its midpoint lies inside one of
that stage's host ranges; a span waits for the card before it closes, so
a stage's kernels run inside its range.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

Event = tuple[str, float, float]  # (name, start_us, end_us)

WINDOW_RANGE = "sapbench.request"
OUTSIDE = "outside any range"


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    stage_device_s: dict[str, float]
    device_ops: list[list]  # [name, seconds], most time first
    idle_gaps: list[list]  # [innermost host range, seconds], most time first
    device_events: int


def _interval_us(ev) -> tuple[float, float]:
    if hasattr(ev, "start_ns"):
        s = ev.start_ns() / 1e3
        return s, s + ev.duration_ns() / 1e3
    s = float(ev.start_us())
    return s, s + float(ev.duration_us())


def from_profiler(prof, host_names: set[str]) -> tuple[list[Event], list[Event]]:
    """Host ranges named in ``host_names`` and every device activity of a
    finished ``torch.profiler.profile`` run, read from the profiler's raw
    events (building its event tree would cost seconds a thousand
    requests).  The profiler mirrors each host range on the device
    timeline under the same name; those mirrors are not device work and
    are dropped."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges, device = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if name not in host_names:
                device.append((name, *_interval_us(ev)))
        elif name in host_names:
            ranges.append((name, *_interval_us(ev)))
    return ranges, device


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost_segments(ranges: list[Event]) -> list[Event]:
    """Non-overlapping segments, each labelled by the innermost host range
    open over it (host ranges nest)."""
    segs: list[Event] = []
    stack: list[Event] = []
    t = float("-inf")
    for name, s, e in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            if top[2] > t:
                segs.append((top[0], t, top[2]))
                t = top[2]
        if stack and s > t:
            segs.append((stack[-1][0], t, s))
        t = max(t, s)
        stack.append((name, s, min(e, stack[-1][2]) if stack else e))
    while stack:
        top = stack.pop()
        if top[2] > t:
            segs.append((top[0], t, top[2]))
            t = top[2]
    return segs


def summarize(ranges: list[Event], device: list[Event], stages: tuple[str, ...],
              top: int = 10) -> TraceSummary:
    """Busy and idle time inside the traced window (the extent of the
    harness's request ranges), device time by stage and by operation."""
    window = [(s, e) for n, s, e in ranges if n == WINDOW_RANGE]
    if not window:
        return TraceSummary(0.0, 0.0, {}, [], [], 0)
    w0, w1 = min(s for s, _ in window), max(e for _, e in window)
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy = _merge([(s, e) for _, s, e in inside])

    stage_s = {}
    for stage in stages:
        spans = sorted((s, e) for n, s, e in ranges if n == stage)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in inside:
            i = bisect.bisect_right(starts, (s + e) / 2) - 1
            if i >= 0 and (s + e) / 2 <= spans[i][1]:
                total += e - s
        stage_s[stage] = total * 1e-6

    by_op: dict[str, float] = defaultdict(float)
    for n, s, e in inside:
        by_op[n[:120]] += (e - s) * 1e-6

    segs = _innermost_segments([r for r in ranges if r[2] > w0 and r[1] < w1])
    idle: dict[str, float] = defaultdict(float)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    i = 0
    for gs, ge in zip(edges[::2], edges[1::2]):
        # split the gap over the segments it overlaps; the rest is outside
        covered = 0.0
        while i < len(segs) and segs[i][2] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][1] < ge:
            part = min(ge, segs[j][2]) - max(gs, segs[j][1])
            if part > 0:
                idle[segs[j][0]] += part * 1e-6
                covered += part
            j += 1
        if ge - gs - covered > 0:
            idle[OUTSIDE] += (ge - gs - covered) * 1e-6

    def ranked(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return TraceSummary(
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        stage_device_s=stage_s,
        device_ops=ranked(by_op),
        idle_gaps=ranked(idle),
        device_events=len(inside),
    )
