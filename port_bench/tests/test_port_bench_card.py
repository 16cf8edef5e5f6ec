"""One short run of each cell on the card (``-m gpu``); skips without one.

    python -m pytest port_bench/tests/test_port_bench_card.py -m gpu -q
"""
import json
import os
import subprocess
import sys

import pytest

from port_bench.harness import manifest

BENCH = manifest.load()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(card, cell):
    proc = subprocess.run(
        [sys.executable, os.path.join("port_bench", "run.py"), "--workload", cell,
         "--seed", "2147483700", "--seconds", "3", "--trace", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert line["breakdown"]["device_ops"]
