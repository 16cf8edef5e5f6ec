"""The program's own spans in a traced slice, and the device's idle time split
among them.

The port marks its frame path's layers with spans named ``fse.*``
(``utils/profiler.py`` ``span``: a ``record_function`` while a profiler
records), so they sit in the profiler's trace on the device's clock.
:func:`reduce` takes the same raw events as :func:`trace.reduce`, inside the
same ``port_bench.window`` mark, and gives:

- ``spans``: by name, ``[host seconds, count, self seconds, idle seconds]``
  of the host events whose name starts with ``fse.``, clipped to the slice.
  Self seconds leave out the time an inner ``fse.`` span is open; idle
  seconds are the device's idle time (no kernel, copy or memset, as
  ``trace.reduce``'s ``busy_s`` counts them) while this span is the
  innermost open ``fse.`` span, taken exactly, not by a gap's middle;
- ``idle_outside_spans_s``: the idle time while no ``fse.`` span is open:
  the caller's (its readback, its loop, numpy).

Every idle second of the slice falls in exactly one of these: the spans'
idle seconds and ``idle_outside_spans_s`` add up to ``window_s - busy_s``.
The innermost span is the open one that started last, so spans of one
thread nest as their ``with`` blocks do.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Optional

from .trace import MARK, _annotation, _on_device, _union

PREFIX = "fse."


def _slice_and_gaps(events):
    """The mark's ``(t0, t1)`` and the device's idle gaps inside it, in time
    order (ns), as ``trace.reduce`` finds them."""
    marks = [e for e in events if e.name() == MARK and not _on_device(e)]
    if not marks:
        raise RuntimeError("the profiler recorded no window mark")
    t0 = marks[0].start_ns()
    t1 = t0 + marks[0].duration_ns()
    device = []
    for e in events:
        if _on_device(e) and not _annotation(e):
            a = max(e.start_ns(), t0)
            b = min(e.start_ns() + e.duration_ns(), t1)
            if b > a:
                device.append((a, b))
    gaps, prev = [], t0
    for a, b in _union(device):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < t1:
        gaps.append((prev, t1))
    return t0, t1, gaps


def reduce(events) -> dict:
    t0, t1, gaps = _slice_and_gaps(events)
    opened = []  # (start, end, index, name), clipped to the slice
    for e in events:
        name = e.name()
        if not name.startswith(PREFIX) or _on_device(e):
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b > t0 and a < t1:
            opened.append((max(a, t0), min(b, t1), len(opened), name))
    table = defaultdict(lambda: [0.0, 0, 0.0, 0.0])
    for a, b, _, name in opened:
        table[name][0] += (b - a) / 1e9
        table[name][1] += 1
    points = sorted({t0, t1, *(s[0] for s in opened), *(s[1] for s in opened)})
    opened.sort()
    outside = 0.0
    active: list = []  # heap of (-start, end, -index, name): the top started last
    i = g = 0
    for lo, hi in zip(points, points[1:]):
        while i < len(opened) and opened[i][0] <= lo:
            a, b, k, name = opened[i]
            heapq.heappush(active, (-a, b, -k, name))
            i += 1
        while active and active[0][1] <= lo:
            heapq.heappop(active)
        while g < len(gaps) and gaps[g][1] <= lo:
            g += 1
        idle, j = 0, g
        while j < len(gaps) and gaps[j][0] < hi:
            idle += min(hi, gaps[j][1]) - max(lo, gaps[j][0])
            j += 1
        if active:
            row = table[active[0][3]]
            row[2] += (hi - lo) / 1e9
            row[3] += idle / 1e9
        else:
            outside += idle / 1e9
    return dict(spans={k: list(v) for k, v in table.items()}, idle_outside_spans_s=outside)


def readings(summary: dict, split: dict, frames: Optional[int]) -> dict:
    """The per-layer numbers the spans give, from ``trace.reduce``'s
    ``summary`` and this module's ``split`` of the same slice: host ms a
    frame inside ``fse.upload`` and inside ``fse.enhance``, and the slice's
    idle share inside the program's spans and outside them (the caller's);
    the two shares add up to the device's idle share. A number whose span
    the slice lacks is None."""
    spans, window = split["spans"], summary["window_s"]

    def host_ms(name):
        return 1e3 * spans[name][0] / frames if name in spans and frames else None

    inside = sum(v[3] for v in spans.values())
    return dict(upload_host_ms=host_ms("fse.upload"), launch_host_ms=host_ms("fse.enhance"),
                idle_in_program_pct=100.0 * inside / window if spans else None,
                idle_caller_pct=100.0 * split["idle_outside_spans_s"] / window,
                device_idle_pct=100.0 * (1.0 - summary["busy_s"] / window))
