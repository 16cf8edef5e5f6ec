"""``chip_smoke.py``'s train phase rehearsed on the CPU at a small size
(moved out of ``test_torch_trainer.py`` so that another worker runs it),
with two torch threads."""
import json

import numpy as np
import pytest
import torch
from PIL import Image


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module's torch work: the test runs
    beside other workers, where eight threads a worker oversubscribe the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_chip_smoke_train_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's train phase rehearsed on the CPU at a small size (on
    a card it runs at 376x288 on the generator's tree): the checks pass, K1
    is never launched on the CPU, the fp32 step runs on the tree's first two
    pairs in sorted order and on the hard batch against an fp64 step that
    replays every kink, and a launch inside a train step, a validation loss
    off apply_eager's, a leaf over 1e-3 of the fp64 step or a kink left
    unreplayed fails them."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    for img in range(2):
        d = tmp_path / "tree" / f"img_{img}"
        d.mkdir(parents=True)
        for loc in range(5):
            base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(base).save(d / f"target_{loc * 8}_0_s0_r0.png")
            for pal in (16, 32):
                Image.fromarray((base // pal) * pal).save(
                    d / f"lores_{loc * 8}_0_s0_r0_rgb444_p{pal}_dNone.png")
    cpu = torch.device("cpu")
    hard = ("img_1/lores_8_0_s0_r0_rgb444_p16_dNone.png",
            "img_1/lores_16_0_s0_r0_rgb444_p32_dNone.png")
    rec = cs.train_phase(cpu, str(tmp_path / "tree"), crop=(32, 32), accum=2, train_samples=4,
                         val_samples=2, timed_accum=2, timed_steps=2, hard_batch=hard)
    cs.check_train(rec, cpu)
    assert rec["pix_shuffle_steps"] == 6 and rec["conv5_steps"] == 2
    assert rec["k1_launches"] == {"train_steps": 0, "all": 0}
    assert [t["micro_batches"] for t in rec["timing"]] == [4, 4]
    assert [t["vgg"] for t in rec["timing"]] == [True, False]
    # the fixed batches: the first two pairs in sorted order, and the hard one
    fp = rec["fp32_step"]
    assert fp["initial_sorted"]["pairs"] == ["img_0/lores_0_0_s0_r0_rgb444_p16_dNone.png",
                                             "img_0/lores_0_0_s0_r0_rgb444_p32_dNone.png"]
    assert fp["trained_hard"]["pairs"] == list(hard)
    # the fp64 reference replays every kink of the fp32 step: both near it,
    # the CPU's fp32 identical to the "card's" here
    for r in fp.values():
        assert r["grad_worst_dev_vs_cpu"] == 0.0 and r["grad_leaves"] == 24
        assert r["kinks_recorded"] > 0 and r["kinks_replayed"] == r["kinks_recorded"]
        assert r["loss_fp64"] == pytest.approx(r["loss_cpu"], rel=1e-5)
        assert r["grad_worst_dev_vs_fp64"][1] <= cs.TRAIN_GRAD_REL
        # the conv biases and the activations' parameters are scaled by
        # their terms' magnitudes, each at least its max |g|
        assert r["grad_leaves_by_terms"] == 17 and r["grad_most_cancelled"][1] > 1.0
        assert r["grad_worst_of_max_g"] <= cs.TRAIN_GRAD_REL
    json.dumps(rec)  # printable as the phase's line
    near = {"l7_act2.slope": dict(dev_vs_fp64=9e-4, dev_vs_cpu=2.2e-3)}
    cs.check_train({**rec, "fp32_step": dict(fp, initial_hard=dict(
        fp["initial_hard"], leaves_over_1e4=near))}, cpu)
    for bad in ({"k1_launches": {"train_steps": 1, "all": 1}}, {"val_rel_diff": 2e-3},
                {"csv_epochs": [1, 2, 2, 3]}, {"conv5_bn_unmoved": 1},
                {"fp32_step": dict(fp, initial_sorted=dict(fp["initial_sorted"], leaves_over_1e4={
                    "conv1.w": dict(dev_vs_fp64=1.1e-3, dev_vs_cpu=5e-4)}))},
                {"fp32_step": dict(fp, trained_hard=dict(fp["trained_hard"], kinks_replayed=(
                    fp["trained_hard"]["kinks_recorded"] - 1)))},
                {"fp32_step": {k: v for k, v in fp.items() if k != "trained_hard"}},
                {"fp32_step": dict(fp, trained_sorted=dict(
                    fp["trained_sorted"], loss_rel_diff=2e-4))}):
        with pytest.raises(AssertionError):
            cs.check_train({**rec, **bad}, cpu)
