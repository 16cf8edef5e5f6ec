"""``BENCHMARK.json`` against the benchmark's contract, and the imports of
the benchmark's own files."""
import ast
import json
import math
import os
import re

import pytest

from port_bench.harness import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "fs_uae_image_enhancer_project_tpu"}
PORT = "fs_uae_image_enhancer_project_tpu_torch"
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    path = os.path.join(manifest.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert not p.startswith("/") and os.path.isdir(os.path.join(manifest.ROOT, p))
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key]), key
    if "unit" in entry:
        assert UNIT.match(entry["unit"])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used, f"{c['name']} has no cell"
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        data = manifest.config(c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert ("graph" in data) != ("graph_from_seed" in data), c["name"]
        assert c["reduced"] == [] and len(c["source"]) <= 200
        assert os.path.exists(os.path.join(manifest.BENCH_DIR, "reference", f"{c['name']}.py"))


def test_operation_counts_follow_from_the_shapes():
    from port_bench.harness import ops

    for c in BENCH["configs"]:
        data = manifest.config(c["name"])
        assert data["flop_per_frame"] == ops.flop_per_frame(data)
        assert data["bytes_per_frame"] == ops.bytes_per_frame(data)
    # K1's count (2 x 136,080 MACs x 288 x 376) and conv6's, as counted when
    # every layer sat at the configuration's one resolution
    for name, flop, size in (("pix_shuffle", 29_471_662_080, 5_470_584),
                             ("conv6", 62_311_514_112, 5_342_118)):
        data = manifest.config(name)
        assert ops.flop_per_frame(data) == data["flop_per_frame"] == flop
        assert ops.bytes_per_frame(data) == data["bytes_per_frame"] == size
    assert manifest.config("pix_shuffle")["flop_per_frame"] == 2 * 136080 * 288 * 376


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert manifest.traffic(w["traffic"])["mode"] in ("offline", "served")
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert BENCH["workloads"][0]["name"] == "pix_shuffle.offline_b8"


def test_metrics():
    names = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(manifest.BENCH_DIR, "metrics", f"{m['name']}.py"))
        for cell in m.get("workloads", []):
            assert cell in names
            reported = {e["name"] for e in manifest.end_to_end(BENCH, cell)}
            assert m["moves"] in reported, f"{cell} reports {m['name']} but not {m['moves']}"
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in names:
        reported = manifest.end_to_end(BENCH, cell)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert manifest.per_layer(BENCH, cell)


def _modules():
    for base, _dirs, files in os.walk(manifest.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_no_jax_and_a_reference_apart(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    rel = os.path.relpath(path, manifest.BENCH_DIR)
    assert not tops & FORBIDDEN, rel
    if rel.startswith("reference"):
        assert PORT not in tops, rel
        assert not {"port_bench"} & tops or all(
            n.startswith("port_bench.reference") for n in _imports(path) if n.startswith("port_bench"))


def test_the_json_files_parse():
    for sub in ("configs", "traffic"):
        for f in os.listdir(os.path.join(manifest.BENCH_DIR, sub)):
            with open(os.path.join(manifest.BENCH_DIR, sub, f)) as fh:
                assert isinstance(json.load(fh), dict)
    assert math.isfinite(BENCH["run_seconds"])
