"""The bench lock: one bench run at a time on the card, trainers yield to it.

Port of the bench-lock half of
``fs_uae_image_enhancer_project_tpu/utils/platform.py``
(``wait_for_bench_lock``, ``register_preemptible_pid``), pure Python with
the same stale-pid and zombie rules, under the port's own lock and pid file
names. A bench run writes its pid to the lock file while it owns the card
and may preempt a registered background trainer (its pid file); a trainer's
restart loop waits here so that it does not come back into a running bench.

The other half of the JAX module, ``honor_jax_platforms_env``, has no
counterpart: it makes ``JAX_PLATFORMS`` binding against a TPU plugin, and
the port names its device explicitly (``resolve_device``, ``device=``).
"""
from __future__ import annotations

import os
import tempfile
import time

BENCH_LOCKFILE = os.path.join(tempfile.gettempdir(), "fse_torch_bench.lock")
PREEMPTIBLE_PIDFILE = os.path.join(tempfile.gettempdir(), "fse_torch_trainer.pid")


def wait_for_bench_lock(lockfile: str = BENCH_LOCKFILE, timeout_s: float = 2400.0,
                        poll_s: float = 5.0) -> None:
    """Block while a bench run holds the card.

    Returns at once when there is no lock file, when it cannot be read or
    parsed, when its pid is dead (a crashed bench's stale lock) or a zombie
    (exited, not yet reaped: it holds no card). Raises ``TimeoutError`` when
    a live holder keeps it past ``timeout_s``.
    """
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(lockfile) as f:
                pid = int(f.read().strip())
            with open(f"/proc/{pid}/stat") as f:
                if f.read().split()[2] == "Z":
                    return
        except (OSError, ValueError):
            return  # no lock, unreadable, or dead pid: stale
        time.sleep(poll_s)
    raise TimeoutError(f"bench lock {lockfile} still held after {timeout_s:.0f}s")


def register_preemptible_pid(pidfile: str = PREEMPTIBLE_PIDFILE,
                             lockfile: str = BENCH_LOCKFILE) -> None:
    """Register this process as a background card user a bench may preempt
    (kill and resume: CSV-resumable trainers, SQLite-resumable studies).
    First waits for a live bench run to release the card."""
    wait_for_bench_lock(lockfile)
    try:
        with open(pidfile, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass
