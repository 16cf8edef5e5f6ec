"""Deadline-safe readiness waits for child processes.

The port's own copy of ``fs_uae_image_enhancer_project_tpu/utils/subproc.py``
(the port imports nothing of the JAX package): ``_ring_put`` and
``wait_for_line``, unchanged.

``proc.stdout.readline()`` blocks indefinitely, so a loop like
``while time.time() < deadline: line = proc.stdout.readline()`` only
re-checks its deadline when the child prints. A child that goes silent
(e.g. a server stuck building its kernels before its first log line) hangs
the parent forever. This helper pumps stdout on a daemon thread and enforces
the deadline from the consumer side; after the token is seen the pump keeps
draining stdout so the child never blocks on a full pipe.

ONE pump per process: the pump thread and its queue are stored on the
proc object, so calling ``wait_for_line`` again after a timeout resumes
consuming the SAME queue. (A naive per-call pump races a retry: the
leaked first thread steals lines — including the readiness token — and
discards them.) Between calls the queue buffers up to ``_QUEUE_MAX``
lines ring-style (oldest dropped), bounding parent RSS under an
hours-long chatty child with no consumer.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Tuple

_QUEUE_MAX = 10_000
_EOF = object()


def _ring_put(q: "queue.Queue", item) -> None:
    """Non-blocking put that drops the oldest entry when full."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def wait_for_line(proc, token: str, timeout: float) -> Tuple[bool, List[str]]:
    """Wait until a line of ``proc.stdout`` (text mode) contains ``token``.

    Returns ``(ok, lines_seen)``; ``ok`` is False on deadline or EOF
    (child exited / closed stdout). Safe to call again on the same proc
    after a timeout — the wait resumes on the same pump/queue. After a
    SUCCESSFUL wait the pump discards all further output (drain-only), so
    a second wait for a different token on the same proc is not supported
    and returns False.
    """
    state = getattr(proc, "_wait_for_line_state", None)
    if state is None:
        q: "queue.Queue" = queue.Queue(maxsize=_QUEUE_MAX)
        satisfied = threading.Event()

        def pump():
            for line in proc.stdout:
                if satisfied.is_set():
                    continue  # post-token lines are discarded, not queued
                _ring_put(q, line)
            _ring_put(q, _EOF)

        threading.Thread(target=pump, daemon=True).start()
        state = (q, satisfied)
        proc._wait_for_line_state = state
    q, satisfied = state

    deadline = time.monotonic() + timeout
    lines: List[str] = []
    if getattr(proc, "_wait_for_line_eof", False):
        return False, lines
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            # do NOT flip `satisfied`: the pump keeps queueing (bounded)
            # so a retry on this proc still sees lines printed meanwhile
            return False, lines
        try:
            line = q.get(timeout=min(remaining, 5.0))
        except queue.Empty:
            continue
        if line is _EOF:
            proc._wait_for_line_eof = True
            return False, lines
        lines.append(line)
        if token in line:
            satisfied.set()
            return True, lines
