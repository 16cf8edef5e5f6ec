"""``chip_smoke.py``'s orbax_write phase rehearsed on the CPU at a small size
(in a file of its own, with two torch threads, so that another worker runs
it beside ``test_torch_orbax_writer.py``)."""
import json

import numpy as np
import pytest
import torch
from PIL import Image


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the test runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    import chip_smoke as cs

    tree = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for img in range(2):
        d = tree / f"img_{img}"
        d.mkdir()
        for loc in range(5):
            base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(base).save(d / f"target_{loc * 8}_0_s0_r0.png")
            for pal in (16, 32):
                Image.fromarray((base // pal) * pal).save(
                    d / f"lores_{loc * 8}_0_s0_r0_rgb444_p{pal}_dNone.png")
    return cs.orbax_write(torch.device("cpu"), str(tree), crop=(32, 32), frame_hw=(48, 80))


# each a fault the check must catch: the path into the record and a bad value
BROKEN = {
    "leaf_read_back_differs": (("pix_shuffle", "read_differing"), ["params.conv1.w"]),
    "conv3_without_buffers": (("conv3", "buffers"), 0),
    "temporary_directory_left": (("conv3", "left_over"),
                                 ["checkpoint_best_conv3.orbax-checkpoint-tmp-0"]),
    "restore_differs": (("conv3", "restored_differing"), ["opt_state.1.nu.conv1.w"]),
    "restored_lr_differs": (("pix_shuffle", "restored_lr"), 1e-3),
    "next_step_differs": (("pix_shuffle", "next_step_differing"), ["params.conv7.b"]),
    "frame_differs": (("pix_shuffle", "frame_equal"), False),
    "k1_launched_on_the_cpu": (("pix_shuffle", "k1_launches"), 2),
    "epoch73_differs": (("epoch73", "differing"), ["opt_state.1.mu.conv1.w"]),
}


def test_chip_smoke_orbax_write_phase_on_the_cpu(rehearsal):
    """The phase's record on the CPU passes its checks: both models' states
    read back, restored and stepped on leaf for leaf, the checkpoint's frame
    equal to the state's, epoch73 written again equal to itself."""
    import chip_smoke as cs

    cs.check_orbax_write(rehearsal, torch.device("cpu"))
    assert rehearsal["pix_shuffle"]["leaves"] == 75  # step, 24 x (param, mu, nu), 2 counts
    assert rehearsal["pix_shuffle"]["frame_shape"] == [1, 48, 80, 4]
    assert len(rehearsal["pix_shuffle"]["write_s"]) == 1 + cs.ORBAX_WRITE_REWRITES
    assert rehearsal["epoch73"]["leaves"] == 75 and rehearsal["epoch73"]["jax_bytes"] > 0
    json.dumps(rehearsal)  # printable as the phase's line


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_check_orbax_write_catches(fault, rehearsal):
    import copy

    import chip_smoke as cs

    (name, key), value = BROKEN[fault]
    bad = copy.deepcopy(rehearsal)
    bad[name][key] = value
    with pytest.raises(AssertionError):
        cs.check_orbax_write(bad, torch.device("cpu"))
