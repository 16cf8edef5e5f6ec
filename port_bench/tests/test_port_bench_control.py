"""Each configuration's control, at a size a test run holds (the CPU, small
frames): the control in the program's place fails the configuration's limit,
where the program passes it. On the card the same comparison ran at the
cells' own size (``tools/readings.py``; ``PERF.md`` has the readings)."""
import pytest
import torch

from port_bench.harness import manifest
from port_bench.tools.readings import offline

CELLS = ["pix_shuffle.offline_b8", "conv6.offline_b8"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    torch.set_num_threads(2)
    c = manifest.cell(manifest.load(), cell)
    got = offline(c, [4242, 2**31 + 3], 0.5, torch.device("cpu"), (48, 80), control=2)
    limit = c["config_data"]["correct"]["worst_mae_levels"]
    assert all(r["worst_mae_levels"] <= limit for r in got["program"]), got["program"]
    assert all(r["worst_mae_levels"] > limit for r in got["control"]), got["control"]
