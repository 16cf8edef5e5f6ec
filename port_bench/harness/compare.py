"""The comparison that decides ``correct``.

What the timed path produced (uint8 frames, as the host received them) is
held to the plain reference's fp32 enhance of the same source frames:

- ``worst_mae_levels``: the largest mean absolute difference of a frame, in
  uint8 levels over every byte, among the frames compared;
- ``worst_rmse_levels`` and ``worst_abs_levels``: the largest root mean
  square difference of a frame, and the largest difference of any byte;
- ``frames_checked``: how many frames were compared.

The configuration's ``correct`` gives the limit of each number that is
compared; every number is printed beside its limit. A run is correct when
every check holds and no frame failed.
"""
from __future__ import annotations

import importlib
import sys
from typing import Dict, List, Tuple

import numpy as np

from ..reference.common import Reference, differences, enhanced_in_blocks
from .graphs import graph_path


def reference(config: dict, device, precision: str = "fp32") -> Reference:
    return Reference(config, graph_path(config), device, precision)


def readings(config: dict, kept: List[Tuple[int, np.ndarray]], frames: np.ndarray,
             device) -> Dict[str, float]:
    """The compared numbers of ``kept`` ``(source index, output frame)`` pairs
    against the reference's enhance of ``frames[source index]``."""
    if not kept:
        return {"worst_mae_levels": 255.0, "worst_rmse_levels": 255.0, "worst_abs_levels": 255,
                "frames_checked": 0}
    idx = sorted({i for i, _ in kept})
    expect = dict(zip(idx, enhanced_in_blocks(reference(config, device), frames[idx])))
    diffs = [differences(out, expect[i]) for i, out in kept]
    return {"worst_mae_levels": max(d["mae"] for d in diffs),
            "worst_rmse_levels": max(d["rmse"] for d in diffs),
            "worst_abs_levels": max(d["max"] for d in diffs), "frames_checked": len(kept)}


def check(value, limit, rule: str) -> dict:
    ok = value <= limit if rule == "<=" else value >= limit if rule == ">=" else value == limit
    return {"value": value, "limit": limit, "rule": rule, "ok": bool(ok)}


def checks(config: dict, got: Dict[str, float], frames_due: int) -> Dict[str, dict]:
    out = {k: check(got[k], limit, "<=") for k, limit in config["correct"].items()}
    out["frames_checked"] = check(got["frames_checked"], frames_due, ">=")
    return out


def launch_check(config: dict, launches: int, calls: int) -> Dict[str, dict]:
    """The main layer's launch counter against the configuration's rule, as
    launches a call (on a card only: the CPU runs no kernel of the port)."""
    main = config["main_layer"]
    per_call = launches / max(calls, 1)
    if "launches_per_call_at_least" in main:
        return {"k1_launches_per_call": check(per_call, main["launches_per_call_at_least"], ">=")}
    return {"k1_launches_per_call": check(per_call, main["launches_per_call_at_most"], "<=")}


def read_counter(config: dict) -> int:
    """The program's launch counter that the configuration names
    (``module:attribute.path``)."""
    module, attr = config["main_layer"]["launch_counter"].split(":")
    value = importlib.import_module(module)
    for part in attr.split("."):
        value = getattr(value, part)
    return int(value)


def print_checks(checks_: Dict[str, dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks_.items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
