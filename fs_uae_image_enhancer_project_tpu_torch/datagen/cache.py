"""Crop-scan result cache with mtime invalidation.

Counterpart of reference ``dataset_generator/cache.py`` (a diskcache wrapper;
diskcache is not in this image, so the store is a single sqlite3 database —
same semantics: JSON values keyed by the full scan-parameter tuple, entries
invalidated when the source image's mtime changes; see :meth:`make_key` for
the deliberate divergence from the reference's under-keyed scheme).
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Any, Optional


class ScanCache:
    def __init__(self, cache_dir: str = ".scan_cache"):
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, "scan_cache.sqlite")
        self._local = threading.local()
        with self._conn() as c:
            c.execute(
                "CREATE TABLE IF NOT EXISTS scan ("
                "key TEXT PRIMARY KEY, mtime REAL, value TEXT)"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0)
            self._local.conn = conn
        return conn

    @staticmethod
    def make_key(img_path: str, rotation: int, downscale: int,
                 grid: str = "tile", crop_w: int = 376, crop_h: int = 288,
                 black_threshold: float = 0.75) -> str:
        # EVERY parameter that determines the cached coordinate set is part
        # of the key: grid mode, crop size, and the black-ratio threshold —
        # otherwise rerunning against the same cache dir with a different
        # --crop_size (or --grid) silently serves the other run's
        # coordinates. The reference keys only (path, rot, ds)
        # (cache.py:20-28) and has exactly that defect; we deliberately
        # diverge. Keys written by earlier revisions of this file (no crop/
        # threshold suffix, or no grid suffix) simply miss and rescan.
        return (f"{img_path}_rot{rotation}_ds{downscale}_grid{grid}"
                f"_c{crop_w}x{crop_h}_b{black_threshold:g}")

    def get(self, key: str, src_path: str) -> Optional[Any]:
        """Return the cached value, or None if absent or the source image
        changed since caching (mtime check, reference cache.py:31-41)."""
        row = self._conn().execute(
            "SELECT mtime, value FROM scan WHERE key = ?", (key,)
        ).fetchone()
        if row is None:
            return None
        try:
            current = os.path.getmtime(src_path)
        except OSError:
            return None
        if abs(current - row[0]) > 1e-6:
            return None
        return json.loads(row[1])

    def put(self, key: str, src_path: str, value: Any) -> None:
        try:
            mtime = os.path.getmtime(src_path)
        except OSError:
            return
        with self._conn() as c:
            c.execute(
                "INSERT OR REPLACE INTO scan (key, mtime, value) VALUES (?, ?, ?)",
                (key, mtime, json.dumps(value)),
            )

    def clear(self) -> None:
        with self._conn() as c:
            c.execute("DELETE FROM scan")
