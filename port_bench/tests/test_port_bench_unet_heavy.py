"""The heavyweight residual U-Net's configuration (``configs/
residual_unet_heavy.json``) and its cell: the listing and the count, its
reference module on a seed-written graph, the faults that must fail its
limit, and a CPU rehearsal of ``run.py`` that ends correct.

The runs here are on the CPU at a small frame with the model at its
published widths; the graph is written once at the configuration's frame
under ``build/port_bench/graphs`` and reused."""
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness import graphs, manifest, ops
from port_bench.reference import residual_unet, residual_unet_heavy
from port_bench.reference.common import Reference
from port_bench.reference.onnx_reader import read_graph
from port_bench.tests import unet
from port_bench.tests.test_port_bench_faults import _broken, _result, altered, half_batch
from port_bench.tests.test_port_bench_ops import counted_convs

CELL = "residual_unet_heavy.offline_b8"
CONFIG = manifest.config("residual_unet_heavy")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_the_listing_is_the_heavyweights_and_its_count_the_forwards():
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model

    height, width = CONFIG["resolution"]["height"], CONFIG["resolution"]["width"]
    assert CONFIG["frame"]["width"] - CONFIG["wrapper"]["crop_left"] == width
    assert CONFIG["layers"] == unet.listing("heavyweight", height, width)
    assert len(CONFIG["layers"]) == 102
    model = get_model("residual_unet", "heavyweight")
    with torch.device("meta"):
        params = model.init(device="meta")
    with counted_convs() as calls:
        model.apply(params, torch.empty(1, height, width, 3, device="meta"))
    assert len(calls) == len(CONFIG["layers"])
    assert ops.flop_per_frame(CONFIG) == CONFIG["flop_per_frame"] == sum(calls)
    assert round(CONFIG["flop_per_frame"] / 1e9, 2) == 1750.74
    assert ops.bytes_per_frame(CONFIG) == CONFIG["bytes_per_frame"]


def test_the_configuration_is_uncut_and_names_the_forward_counter():
    spec = CONFIG["graph_from_seed"]
    assert spec == {"family": "residual_unet", "variant": "heavyweight", "seed": 7,
                    "dtype": "float32"}
    assert CONFIG["compute_dtype"] == "bfloat16" and CONFIG["control"] == "reference_fp8"
    # published widths: blocks of 72-576 channels, 108-864 inside them
    mids = {l["cout"] for l in CONFIG["layers"] if l["name"].endswith(".conv2")}
    outs = {l["cout"] for l in CONFIG["layers"] if l["name"].endswith(".conv3")}
    assert mids == {108, 216, 432, 864} and outs == {72, 144, 288, 576}
    main = CONFIG["main_layer"]
    assert main["launch_counter"].endswith("models.residual_unet:apply.forwards")
    assert main["launches_per_call_at_least"] == 1 and "fse_conv" in main["kernels"]
    from port_bench.harness.compare import read_counter

    assert read_counter(CONFIG) >= 0


def test_the_reference_module_reads_a_seed_written_graph():
    path = graphs.graph_path(CONFIG)
    inits = read_graph(path).initializers
    assert residual_unet.structure(inits) == (4, 4)
    assert residual_unet_heavy.ops(inits) == residual_unet.ops(inits)
    assert residual_unet_heavy.forward is residual_unet.forward
    ref = Reference(CONFIG, path, "cpu")
    assert ref.model is residual_unet_heavy
    assert sum(v.numel() for k, v in ref.weights.items() if not k.startswith("gamma_")) == (
        114_025_872)


@pytest.mark.parametrize("fault", [half_batch, altered], ids=["half_batch", "altered"])
def test_an_offline_fault_is_not_correct(fault, monkeypatch):
    _broken(monkeypatch, fault)
    line = _result(CELL)
    assert line["correct"] is False
    assert not line["checks"]["worst_mae_levels"]["ok"]


def test_a_cpu_rehearsal_of_the_cell_is_correct():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join("port_bench", "run.py"), "--workload", CELL,
         "--seed", str(2**31 + 25), "--seconds", "6", "--trace", "0", "--device", "cpu",
         "--frame", "64x96"],
        cwd=manifest.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, line
    assert line["checks"]["frames_checked"]["value"] == 32
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}


def test_the_control_is_not_correct():
    from port_bench.tools.readings import offline

    c = manifest.cell(manifest.load(), CELL)
    got = offline(c, [4243, 2**31 + 9], 0.3, torch.device("cpu"), (32, 48), control=2)
    for key, limit in CONFIG["correct"].items():
        assert all(r[key] <= limit for r in got["program"]), (key, got["program"])
        assert all(r[key] > limit for r in got["control"]), (key, got["control"])
