"""A traced slice of a run, reduced to what the per-layer metrics read.

``Slice`` runs ``torch.profiler`` (CPU, and CUDA where a card is used) and
marks the slice with a record named ``port_bench.window``; :func:`reduce`
takes the profiler's raw events and gives, inside that mark:

- ``window_s``: the slice's length on the profiler's clock;
- ``busy_s``: the time in which a kernel, a copy or a memset ran on the
  device (the union of their intervals);
- ``kernels`` and ``copies``: seconds and count by name (a copy is an event
  whose name starts with ``Memcpy``);
- ``idle_by_host``: the device's idle seconds by what the host was doing,
  the innermost host event that covers each gap's middle (``(no torch op)``
  where none does: Python, sockets, numpy).
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Optional

MARK = "port_bench.window"
NO_OP = "(no torch op)"


class Slice:
    """``start()`` and ``stop()`` a profiled slice, then ``summary()``."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = self.mark = None

    def warm(self) -> None:
        """Start and stop the profiler once on nothing, so that its own first
        start (CUPTI's) falls into set-up and not into a window."""
        self.start()
        self.stop()
        self.prof = self.mark = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self._torch = torch

    def stop(self) -> None:
        self.mark.__exit__(None, None, None)
        if self.cuda:
            self._torch.cuda.synchronize()
        self.prof.stop()

    def summary(self, frames: Optional[int] = None) -> dict:
        out = reduce(self.prof.profiler.kineto_results.events())
        out["frames"] = frames
        return out


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    """A user's mark (``record_function``), which the profiler also lays on
    the device's timeline: no work of the device."""
    if e.name() == MARK:
        return True
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _union(intervals):
    """Merged, sorted intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events) -> dict:
    marks = [e for e in events if e.name() == MARK and not _on_device(e)]
    if not marks:
        raise RuntimeError("the profiler recorded no window mark")
    t0 = marks[0].start_ns()
    t1 = t0 + marks[0].duration_ns()
    kernels = defaultdict(lambda: [0.0, 0])
    copies = defaultdict(lambda: [0.0, 0])
    device, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if _on_device(e):
            if _annotation(e):
                continue
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            device.append((a, b))
            slot = (copies if e.name().startswith("Memcpy") else kernels)[e.name()]
            slot[0] += (b - a) / 1e9
            slot[1] += 1
        elif e.name() != MARK and b > t0 and a < t1:
            host.append((a, b, e.name()))
    busy = _union(device)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < t1:
        gaps.append((prev, t1))
    return dict(window_s=(t1 - t0) / 1e9,
                busy_s=sum(b - a for a, b in busy) / 1e9,
                kernels={k: list(v) for k, v in kernels.items()},
                copies={k: list(v) for k, v in copies.items()},
                idle_by_host=_idle_by_host(gaps, host))


def _idle_by_host(gaps, host) -> dict:
    """Idle seconds by the innermost host event over each gap's middle."""
    host.sort()
    out = defaultdict(float)
    active: list = []  # heap of (end, -start, name)
    i = 0
    for a, b in gaps:  # gaps come in time order
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], -host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        over = [t for t in active if t[0] >= mid]
        name = max(over, key=lambda t: -t[1])[2] if over else NO_OP
        out[name] += (b - a) / 1e9
    return dict(out)


def top(table: dict, n: int = 10):
    """The ``n`` largest entries of a ``{name: seconds or [seconds, count]}``
    table, as ``[[name, seconds], ...]``."""
    rows = [[k, v[0] if isinstance(v, list) else v] for k, v in table.items()]
    return sorted(rows, key=lambda r: -r[1])[:n]


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time, and the device's idle time by what the host was doing."""
    ops = dict(summary["kernels"], **summary["copies"])
    return {"device_ops": top(ops), "idle_gaps": top(summary["idle_by_host"])}


def matching(table: dict, patterns) -> float:
    """Seconds of the entries whose name contains any of ``patterns``."""
    return sum(v[0] for k, v in table.items() if any(p in k for p in patterns))
