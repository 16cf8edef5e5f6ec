"""``run.py`` rehearsed on the CPU at a small frame, each traffic mix, with
``--trace 0`` and ``1``: the contract's last line, a CPU device and no
device metric."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import manifest

BENCH = manifest.load()
DEVICE_METRICS = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}
CELLS = ["pix_shuffle.offline_b8", "conv6.served_1x50"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_prints_the_contracts_line(cell, trace):
    if manifest.cell(BENCH, cell)["traffic_data"]["mode"] == "served" and not (
            shutil.which("cc") or shutil.which("gcc")):
        pytest.skip("no C compiler to build the load generator")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join("port_bench", "run.py"), "--workload", cell,
         "--seed", str(2**31 + 17), "--seconds", "1.5", "--trace", str(trace),
         "--device", "cpu", "--frame", "48x80"],
        cwd=manifest.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["kind"] == "cpu"
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert not DEVICE_METRICS & set(line["metrics"])
    names = {m["name"] for m in (manifest.per_layer(BENCH, cell) if trace
                                 else manifest.end_to_end(BENCH, cell))}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    last = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(l.startswith("check ") for l in last)


def test_the_cell_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join("port_bench", "run.py"), "--workload",
         "pix_shuffle.offline_b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
