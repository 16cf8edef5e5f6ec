"""The process's start on ``time.monotonic()``'s clock, for ``setup_s``."""
from __future__ import annotations

import os
import time


def process_start() -> float:
    """When this process started, read from ``/proc/self/stat`` (its start
    in clock ticks after boot) against ``CLOCK_BOOTTIME``; the time of this
    call where that cannot be read."""
    now_mono = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now_mono - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return now_mono
