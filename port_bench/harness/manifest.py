"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``configs/<name>.json``, its reference
  ``reference/<name>.py``;
- a traffic mix: ``traffic/<name>.json``, whose ``mode`` names the module
  that generates its load (``harness/offline.py`` or ``harness/served.py``);
- a per-layer metric: ``metrics/<name>.py``, with ``read(ctx)``.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", f"{name}.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def cell(manifest: dict, name: str) -> dict:
    """The workload entry ``name``, its configuration and its traffic. A name
    ``<config>.<traffic>`` that ``BENCHMARK.json`` does not list runs as an
    unlisted cell on one card, for the tools and the tests: it reports only
    the metrics that every cell reports."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            return dict(w, config_data=config(w["config"]), traffic_data=traffic(w["traffic"]))
    cfg, _, mix = name.partition(".")
    try:
        return dict(name=name, config=cfg, traffic=mix, chips=1, config_data=config(cfg),
                    traffic_data=traffic(mix))
    except FileNotFoundError:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(manifest: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in manifest["end_to_end"] if _reports(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    without a list whose ``moves`` metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(metric_name: str) -> Callable[[dict], Optional[float]]:
    """``read(ctx)`` of ``metrics/<metric_name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric_name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_all(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric's value, left out where its reader finds nothing."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
