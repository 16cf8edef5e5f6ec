"""A configuration's graph made from a seed (``harness/graphs.py``), with the
lightweight residual U-Net at a small frame: the file, both readers, the
refusals, and a whole CPU run on a configuration held here, not under
``configs/``."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench.harness import graphs, manifest
from port_bench.harness.frames import recording
from port_bench.reference import seeded
from port_bench.reference.common import Reference, differences
from port_bench.reference.onnx_reader import read_graph
from port_bench.tests import unet

PORT = "fs_uae_image_enhancer_project_tpu_torch"


@pytest.fixture(scope="module")
def frames():
    torch.set_num_threads(2)
    return recording(11, 4, 32, 48, 32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_one_seed_writes_one_file_and_another_seed_another(tmp_path):
    a = graphs.graph_path(unet.config(seed=7), root=str(tmp_path / "a"))
    b = graphs.graph_path(unet.config(seed=7), root=str(tmp_path / "b"))
    c = graphs.graph_path(unet.config(seed=8), root=str(tmp_path / "a"))
    assert os.path.relpath(a, tmp_path / "a") == os.path.join(
        "build", "port_bench", "graphs", "residual_unet-7-float32.onnx")
    assert _bytes(a) == _bytes(b) != _bytes(c)
    assert sorted(os.listdir(os.path.dirname(a))) == [
        "residual_unet-7-float32.onnx", "residual_unet-8-float32.onnx"]


def test_a_written_graph_is_used_as_it_is(tmp_path):
    path = graphs.graph_path(unet.config(), root=str(tmp_path))
    os.utime(path, (1, 1))
    assert graphs.graph_path(unet.config(), root=str(tmp_path)) == path
    assert os.stat(path).st_mtime == 1


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_the_graph_holds_the_draw(tmp_path, dtype):
    config = unet.config(dtype=dtype)
    graph = read_graph(graphs.graph_path(config, root=str(tmp_path)))
    made = seeded.initializers(config)
    assert graph.name == "fs_uae_enhance_unet"
    for key, arr in made.items():
        assert graph.initializers[key].dtype == np.dtype(dtype), key
        np.testing.assert_array_equal(graph.initializers[key], arr, err_msg=key)
    convs = {k for k in graph.initializers if k.endswith((".weight", ".bias"))}
    assert convs == {k for k in made if not k.startswith("gamma_")}


def test_the_program_and_the_reference_read_the_file(tmp_path, frames):
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx

    config = unet.config()
    path = graphs.graph_path(config, root=str(tmp_path))
    ref = Reference(config, path, "cpu")(frames).numpy()
    fp32 = enhance_from_onnx(path, device="cpu", compute_dtype=torch.float32)(frames).numpy()
    assert all(differences(p, r)["max"] <= 1 for p, r in zip(fp32, ref))
    bf16 = enhance_from_onnx(path, device="cpu")(frames).numpy()
    worst = max(differences(p, r)["mae"] for p, r in zip(bf16, ref))
    assert 0 < worst < config["correct"]["worst_mae_levels"]
    # the output is no flat image: the comparison has something to compare
    assert ref[..., unet.CROP:, :3].std() > 10


def test_the_reference_takes_its_weights_from_the_draw_not_the_graph(tmp_path, frames):
    config = unet.config(seed=7)
    path = graphs.graph_path(config, root=str(tmp_path))
    other = graphs.graph_path(unet.config(seed=8), root=str(tmp_path))
    ours = Reference(config, path, "cpu")(frames[:1]).numpy()
    assert (Reference(config, other, "cpu")(frames[:1]).numpy() == ours).all()
    assert (Reference(unet.config(seed=8), other, "cpu")(frames[:1]).numpy() != ours).any()


@pytest.mark.parametrize("graphs_given", ["both", "neither"])
def test_a_configuration_must_give_one_graph(graphs_given):
    config = unet.config()
    if graphs_given == "both":
        config["graph"] = "artifacts/model_residual_unet/residual_unet.onnx"
    else:
        del config["graph_from_seed"]
    with pytest.raises(ValueError, match="exactly one of"):
        graphs.graph_path(config)


def test_a_listing_that_is_not_the_variants_is_refused(tmp_path):
    light = unet.config()
    heavy_spec = dict(light["graph_from_seed"], variant="heavyweight")
    with pytest.raises(ValueError, match="is not the residual_unet heavyweight"):
        graphs.graph_path(dict(light, graph_from_seed=heavy_spec), root=str(tmp_path))
    extra = dict(light, layers=light["layers"] + [
        {"name": "extra", "cin": 3, "cout": 3, "k": 1}])
    with pytest.raises(ValueError, match="does not have"):
        graphs.graph_path(extra, root=str(tmp_path))
    assert not (tmp_path / graphs.GRAPHS).exists()


def test_the_shipped_lightweight_graph_is_the_unet_the_reference_reads(frames):
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx

    path = os.path.join(manifest.ROOT, "artifacts", "model_residual_unet", "residual_unet.onnx")
    config = {k: v for k, v in unet.config().items() if k != "graph_from_seed"}
    config["graph"] = os.path.relpath(path, manifest.ROOT)
    ref = Reference(config, graphs.graph_path(config), "cpu")(frames).numpy()
    port = enhance_from_onnx(path, device="cpu", compute_dtype=torch.float32)(frames).numpy()
    assert all(differences(p, r)["max"] <= 1 for p, r in zip(port, ref))


def test_a_cpu_run_on_a_configuration_held_here(tmp_path):
    """``run.py`` in a copy of the benchmark that holds one more
    configuration: its graph is written in the copy and the run is correct."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(manifest.ROOT, PORT), tmp_path / PORT)
    with open(tmp_path / "port_bench" / "configs" / "residual_unet.json", "w") as f:
        json.dump(unet.config(seed=2**31 + 5), f)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join("port_bench", "run.py"), "--workload",
         "residual_unet.offline_b8", "--seed", str(2**33 + 3), "--seconds", "1.5",
         "--trace", "0", "--device", "cpu", "--frame", "32x48"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0, line
    assert line["checks"]["frames_checked"]["value"] == 32
    assert os.listdir(tmp_path / graphs.GRAPHS) == [f"residual_unet-{2**31 + 5}-float32.onnx"]
