"""The plain reference against the port's CPU enhance of both shipped
graphs, on small frames. The reference imports nothing of the port; this
test imports both."""
import numpy as np
import pytest
import torch

from port_bench.harness import manifest
from port_bench.harness.frames import recording
from port_bench.harness.graphs import graph_path
from port_bench.reference import pix_shuffle as ref_pix
from port_bench.reference.common import Reference, differences
from port_bench.reference.onnx_reader import read_graph

CONFIGS = ["pix_shuffle", "conv6"]


def _graph(name):
    return graph_path(manifest.config(name))


@pytest.fixture(scope="module")
def frames():
    torch.set_num_threads(2)
    return recording(5, 4, 48, 80, 32)


@pytest.mark.parametrize("name", CONFIGS)
def test_reader_matches_the_ports_reader(name):
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_proto import load_model

    ours, theirs = read_graph(_graph(name)), load_model(_graph(name)).graph
    assert ours.name == theirs.name
    assert [n.op_type for n in ours.nodes] == [n.op_type for n in theirs.nodes]
    assert [n.inputs for n in ours.nodes] == [n.inputs for n in theirs.nodes]
    assert sorted(ours.initializers) == sorted(theirs.initializers)
    for key, arr in ours.initializers.items():
        np.testing.assert_array_equal(arr, theirs.initializers[key].to_numpy())


@pytest.mark.parametrize("name", CONFIGS)
def test_fp32_reference_is_the_ports_fp32_enhance(name, frames):
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx

    port = enhance_from_onnx(_graph(name), device="cpu", compute_dtype=torch.float32)(frames)
    ref = Reference(manifest.config(name), _graph(name), "cpu")(frames)
    d = differences(port.numpy(), ref.numpy())
    assert d["max"] <= 1 and d["mae"] < 0.01, d


@pytest.mark.parametrize("name", CONFIGS)
def test_ports_bf16_enhance_is_within_the_limit(name, frames):
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx

    config = manifest.config(name)
    port = enhance_from_onnx(_graph(name), device="cpu")(frames).numpy()
    ref = Reference(config, _graph(name), "cpu")(frames).numpy()
    worst = max(differences(p, r)["mae"] for p, r in zip(port, ref))
    assert 0 < worst < config["correct"]["worst_mae_levels"]


def test_wrapper_contract(frames):
    config = manifest.config("pix_shuffle")
    out = Reference(config, _graph("pix_shuffle"), "cpu")(frames).numpy()
    assert out.shape == frames.shape and out.dtype == np.uint8
    assert (out[..., 3] == 255).all()


def test_shuffle_inverts_unshuffle():
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    u = ref_pix.unshuffle(x)
    assert u.shape == (2, 12, 2, 3)
    # CRD order: channel c * 4 + dy * 2 + dx holds pixel (2y + dy, 2x + dx)
    assert u[0, 1 * 4 + 1 * 2 + 0, 1, 2] == x[0, 1, 3, 4]
    torch.testing.assert_close(ref_pix.shuffle(u), x)


def test_a_graph_of_another_shape_is_refused(tmp_path):
    config = dict(manifest.config("conv6"), name="pix_shuffle")
    with pytest.raises(ValueError, match="not the graph"):
        Reference(config, _graph("conv6"), "cpu")
