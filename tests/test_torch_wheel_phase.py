"""``chip_smoke.py``'s wheel phase rehearsed on the CPU at a small frame: the
repo's wheel built and installed into a temporary directory, its
``fse-torch-sidecar`` serving two 48x80 frames byte-equal to the checkout's
enhance; then the phase's check held to that record, to a record as a card
gives it, and to one fault of each kind it must catch."""
import copy
import json
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "fs_uae_image_enhancer_project_tpu_torch"
CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads here and in the server child: the test runs
    beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rehearsal():
    import chip_smoke as cs

    return cs.wheel_phase(CPU, frame_hw=(48, 80), n_frames=2)


@pytest.fixture(scope="module")
def on_card(rehearsal):
    """The rehearsal's record as the card's run gives it: K1 once a frame
    and the warm-up, and the library built cold into the cache."""
    lib = os.path.relpath(rehearsal["library"], rehearsal["cache"])
    return dict(rehearsal, k1_launches=rehearsal["frames"] + 1, built=True, build_s=6.5,
                cache_files=[lib, lib + ".ptxas.log"])


def test_chip_smoke_wheel_phase_on_the_cpu(rehearsal):
    """The phase's record on the CPU passes its checks and gives its
    seconds; nothing is left in the checkout or in the temporary tree."""
    import chip_smoke as cs

    cs.check_wheel(rehearsal, CPU)
    assert rehearsal["wheel_s"] > 0 and rehearsal["wheel_bytes"] > 0
    assert rehearsal["install_s"] > 0 and rehearsal["ready_s"] > 0
    assert rehearsal["repo_added"] == []
    assert not os.path.exists(rehearsal["target"])  # the temporary tree is gone
    json.dumps(rehearsal)  # printable as the phase's line


def test_installed_sidecar_serves_the_checkouts_frames(rehearsal):
    """The installed ``bin/fse-torch-sidecar --device cpu`` on the shipped
    pix_shuffle graph answers two 48x80 frames at depth 2, byte-equal to the
    checkout's ``enhance_from_onnx`` on the CPU; its stats name the
    install's module and the cache's library, which no CPU frame builds."""
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    assert rehearsal["server_rc"] == 0 and rehearsal["depth"] == 2
    assert rehearsal["responses"] == rehearsal["served_frames"] == 2
    assert rehearsal["equal"] == [True, True]
    assert rehearsal["k1_launches"] == 0
    assert rehearsal["first_frame_ms"] > 0 and rehearsal["p50_ms"] > 0
    assert rehearsal["module"].startswith(rehearsal["target"] + os.sep)
    assert rehearsal["library"] == os.path.join(
        rehearsal["cache"], PORT, "torch_kernels",
        os.path.basename(os.path.dirname(build.library_path())), build.LIB_NAME)
    assert rehearsal["built"] is None and rehearsal["build_s"] is None
    assert rehearsal["cache_files"] == []  # nothing built


def test_check_wheel_passes_a_card_record(on_card):
    import chip_smoke as cs

    cs.check_wheel(on_card, CUDA)
    with pytest.raises(AssertionError):  # K1 launched and a build on the CPU
        cs.check_wheel(on_card, CPU)


def _other_hash(rec):
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    return os.path.join(rec["cache"], PORT, "torch_kernels", "0123456789abcdef", build.LIB_NAME)


# each a fault the check must catch on the card: the key and a bad value
# (a function of the record)
BROKEN = {
    "a_response_differs": ("equal", lambda r: [True, False]),
    "a_response_missing": ("responses", lambda r: 1),
    "k1_not_launched": ("k1_launches", lambda r: 0),
    "module_from_the_checkout": (
        "module", lambda r: os.path.join(REPO, PORT, "ops", "cuda", "fused_stack.py")),
    "library_outside_the_cache": ("library", lambda r: r["checkout_library"]),
    "hash_directory_differs": ("library", _other_hash),
    "build_not_cold": ("built", lambda r: False),
    "no_build_seconds": ("build_s", lambda r: 0.0),
    "library_not_in_the_cache": ("cache_files", lambda r: []),
    "server_failed": ("server_rc", lambda r: 1),
    "file_left_in_the_repo": (
        "repo_added", lambda r: ["fs_uae_image_enhancer_project_tpu.egg-info"]),
}


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_check_wheel_catches(fault, on_card):
    import chip_smoke as cs

    key, value = BROKEN[fault]
    bad = copy.deepcopy(on_card)
    bad[key] = value(on_card)
    with pytest.raises(AssertionError):
        cs.check_wheel(bad, CUDA)
