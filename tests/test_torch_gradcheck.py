"""``train/gradcheck.py`` on the CPU, at 32x32: recording a step's kinks
leaves the step as it is (every op of the forward and backward passes run,
the loss and fp32 gradients bit for bit), a replay of a record takes the
recorded branches with the production ops' derivatives, a record that
does not fit the replayed run raises, and the terms a broadcast leaf's
gradient sums are those of the leaf expanded by hand."""
import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.train import gradcheck as gc

CPU = torch.device("cpu")


class OpLog(TorchDispatchMode):
    """Counts the aten ops run under it, backward passes included."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def step_inputs():
    """The lightweight pix_shuffle's seeded weights and a uint8 batch of 2
    with ties throughout (4x4 blocks of one value, as uint8 frames give)."""
    m = get_model("pix_shuffle")
    weights = {k: {n: t.detach() for n, t in v.items()}
               for k, v in m.init(torch.Generator().manual_seed(0), device="cpu").items()}
    rng = np.random.default_rng(0)
    lr_b = rng.integers(0, 256, (2, 8, 8, 3), np.uint8).repeat(4, 1).repeat(4, 2)
    hr_b = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
    return m, weights, lr_b, hr_b


def test_recording_leaves_the_fp32_step_bit_identical(step_inputs):
    m, weights, lr_b, hr_b = step_inputs
    plain, recording = OpLog(), OpLog()
    with plain:
        loss, grads = gc.fp32_step(m, weights, lr_b, hr_b, CPU)
    decisions = []
    with recording:
        rec_loss, rec_grads = gc.fp32_step(m, weights, lr_b, hr_b, CPU, decisions)
    # the step's own ops all run (threshold_backward, max-pool's backward,
    # ...), with only the decisions' comparisons and argmaxes beside them
    assert not plain.ops - recording.ops
    assert set(recording.ops - plain.ops) <= {"gt", "lt", "eq", "stack", "expand",
                                              "max_pool2d_with_indices"}
    assert rec_loss == loss
    assert len(rec_grads) == len(grads) == 24
    assert all(torch.equal(a, b) for a, b in zip(rec_grads, grads))
    # the L1 terms' signs, VGG's ReLU masks and max-pools, the clips
    assert {k for k, _, _ in decisions} == {"where", "relu", "max_pool2d", "maximum", "minimum"}


def test_replay_takes_the_production_ops_derivatives(step_inputs):
    """fp64's own branches, recorded and replayed: the plain fp64 gradient."""
    m, weights, lr_b, hr_b = step_inputs
    decisions = []
    with gc.kink_mode(decisions, replay=False):
        loss, grads, _ = gc.fp64_step(m, weights, lr_b, hr_b, CPU)
    plain_loss, plain, _ = gc.fp64_step(m, weights, lr_b, hr_b, CPU)
    assert loss == plain_loss and all(torch.equal(a, b) for a, b in zip(grads, plain))
    again, replayed_grads, replayed = gc.fp64_step(m, weights, lr_b, hr_b, CPU, decisions)
    assert replayed == len(decisions) > 0
    assert again == pytest.approx(loss, rel=1e-12)
    for a, b in zip(replayed_grads, grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10 * float(b.abs().max()))


def test_replay_follows_the_record_and_refuses_a_misfit(step_inputs):
    """A relu mask flipped in the record moves the replayed gradient; a
    record of another shape raises."""
    m, weights, lr_b, hr_b = step_inputs
    decisions = []
    gc.fp32_step(m, weights, lr_b, hr_b, CPU, decisions)
    _, base, _ = gc.fp64_step(m, weights, lr_b, hr_b, CPU, decisions)
    i = next(j for j, (k, _, _) in enumerate(decisions) if k == "relu")
    kind, shape, mask = decisions[i]
    flipped = decisions[:i] + [(kind, shape, ~mask)] + decisions[i + 1:]
    _, moved, _ = gc.fp64_step(m, weights, lr_b, hr_b, CPU, flipped)
    assert any(not torch.equal(a, b) for a, b in zip(moved, base))
    with pytest.raises(RuntimeError, match="replay at"):
        gc.fp64_step(m, weights, lr_b[:, :16, :16], hr_b[:, :16, :16], CPU, decisions)


def test_contribution_sums_are_the_broadcast_terms(step_inputs, monkeypatch):
    """The fp64 step's gradients with the terms taken equal those without;
    every conv bias and activation parameter has its terms' magnitudes (at
    least its |g|), the conv weights none; and sinlu's two scalars get the
    sums of a forward that expands them to the activation by hand."""
    from fs_uae_image_enhancer_project_tpu_torch.models import pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.ops import activations

    m, weights, lr_b, hr_b = step_inputs
    names = gc.leaf_names(weights)
    decisions, sums = [], []
    gc.fp32_step(m, weights, lr_b, hr_b, CPU, decisions)
    loss, grads, _ = gc.fp64_step(m, weights, lr_b, hr_b, CPU, decisions, sums)
    plain_loss, plain, _ = gc.fp64_step(m, weights, lr_b, hr_b, CPU, decisions)
    assert loss == plain_loss and all(torch.equal(a, b) for a, b in zip(grads, plain))
    assert [n for n, s in zip(names, sums) if s is None] == [
        f"conv{i}.w" for i in range(1, 8)]
    for g, s in zip(grads, sums):
        assert s is None or (s.shape == g.shape and bool((s >= g.abs() * (1 - 1e-12)).all()))

    by_hand = {}

    def expanded(name, params, x, config=None):
        if name != "sinlu":
            return activations.apply_activation(name, params, x, config)
        ab = [params[k].reshape(()).expand(x.shape) for k in ("a", "b")]
        for k, t in zip(("a", "b"), ab):
            t.register_hook(lambda g, key=(id(params[k]), k): by_hand.__setitem__(
                key, by_hand.get(key, 0.0) + float(g.abs().sum())))
        return torch.sigmoid(x) * (x + ab[0] * torch.sin(ab[1] * x))

    monkeypatch.setattr(pix_shuffle, "apply_activation", expanded)
    gc.fp64_step(m, weights, lr_b, hr_b, CPU, decisions)
    sinlu = [n for n in names if "_act" in n and n.endswith((".a", ".b"))]
    assert len(sinlu) == len(by_hand) == 4
    want = sorted(by_hand.values())
    got = sorted(float(s) for n, s in zip(names, sums) if n in sinlu)
    assert got == pytest.approx(want, rel=1e-12)
