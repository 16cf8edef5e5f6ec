"""The port's train step against the JAX package's, on the CPU.

The same JAX-initialized weights and seeded batches through both steps:
- pix_shuffle lightweight at full width (its own criterion, VGG on the
  committed self-trained asset) on 16x16 crops, fp32, 2 micro-batches: the
  loss within rel 1e-5, every gradient leaf within 1e-4 x that leaf's
  max |g|;
- conv3 (BatchNorm) the same, and its running stats after the step within
  abs 1e-5;
- the optimizer: 5 steps of seeded gradients with steps_per_epoch=2 against
  the optax chain, parameters within abs 1e-6;
- a bf16 step: the loss within rel 2e-2 of JAX's bf16 loss;
- conv3 under sp (a 1 x 2 mesh of gloo ranks) against JAX's step on its
  1 x 2 mesh, at ``tests/test_torch_parallel.py``'s tolerances.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.losses import build_criterion as jax_criterion
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.parallel import train_step as J
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax, params_to_numpy
from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
from fs_uae_image_enhancer_project_tpu_torch.models import get_model, pix_shuffle, train_apply
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack
from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as T
from fs_uae_image_enhancer_project_tpu_torch.parallel.mesh import Mesh


def _capture_grads():
    """An optax transformation that leaves the parameters alone and keeps
    the step's (averaged) gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _batches(n_micro, per_micro, side=16, seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.integers(0, 256, (n_micro, per_micro, side, side, 3), dtype=np.uint8)
    lr = ((hr // 32) * 32).astype(np.uint8)
    return lr, hr


def _jax_step(name, jparams, lr, hr, compute_dtype):
    jm = jax_model(name)
    has_bn = name != "pix_shuffle"
    from fs_uae_image_enhancer_project_tpu.data.dataset import batch_transform

    state = J.init_train_state(jparams, _capture_grads(), has_batchnorm=has_bn)
    step = jax.jit(J.make_train_step(jm.apply, jax_criterion(jm.loss), _capture_grads(),
                                     has_batchnorm=has_bn, compute_dtype=compute_dtype,
                                     input_transform=batch_transform(jm.linear_io)))
    new, loss = step(state, jnp.asarray(lr), jnp.asarray(hr))
    return float(loss), params_to_numpy(params_from_jax(
        jax.tree_util.tree_map(np.asarray, new.opt_state), device="cpu")), new.buffers


def _port_step(name, jparams, lr, hr, compute_dtype):
    m = get_model(name)
    has_bn = name != "pix_shuffle"
    from fs_uae_image_enhancer_project_tpu_torch.data.dataset import batch_transform

    state = T.init_train_state(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                               device="cpu"),
                               T.make_optimizer(lr=0.0, weight_decay=0.0),
                               has_batchnorm=has_bn)
    step = T.make_train_step(train_apply(m), build_criterion(m.loss, device="cpu"),
                             has_batchnorm=has_bn, compute_dtype=compute_dtype,
                             input_transform=batch_transform(m.linear_io))
    new, loss = step(state, torch.from_numpy(lr), torch.from_numpy(hr))
    grads = {}

    def walk(node, out):
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = {}
                walk(v, out[k])
            else:
                out[k] = v.grad.numpy().copy()

    walk(new.params, grads)
    return loss, grads, new


def _check_grads(got, want, rel):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w) > 0
    for path, g in flat_g:
        w = flat_w[path]
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (path, np.abs(g - w).max(),
                                                               np.abs(w).max())


@pytest.mark.parametrize("name", ["pix_shuffle", "conv3"])
def test_fp32_step_matches_jax(name):
    jparams = jax_model(name).init(jax.random.key(0))
    lr, hr = _batches(2, 2 if name == "conv3" else 1)
    want_loss, want_grads, want_buffers = _jax_step(name, jparams, lr, hr, jnp.float32)
    loss, grads, state = _port_step(name, jparams, lr, hr, torch.float32)
    assert loss.dim() == 0 and loss.dtype == torch.float32
    assert loss.item() == pytest.approx(want_loss, rel=1e-5)
    _check_grads(grads, want_grads, 1e-4)
    assert state.step == 1
    if name == "conv3":
        assert set(state.buffers) == {"bn1", "bn2", "bn3"}
        for k, stats in state.buffers.items():
            for s in ("mean", "var"):
                np.testing.assert_allclose(stats[s].numpy(), np.asarray(want_buffers[k][s]),
                                           atol=1e-5)
        # the stats moved from torch's defaults, through both micro-batches
        assert not torch.equal(state.buffers["bn1"]["mean"], torch.zeros(32))


def test_bf16_step_loss_matches_jax():
    jparams = jax_model("pix_shuffle").init(jax.random.key(1))
    lr, hr = _batches(2, 1, seed=3)
    want_loss, _, _ = _jax_step("pix_shuffle", jparams, lr, hr, jnp.bfloat16)
    loss, grads, _ = _port_step("pix_shuffle", jparams, lr, hr, torch.bfloat16)
    assert loss.item() == pytest.approx(want_loss, rel=2e-2)
    assert all(np.isfinite(g).all() for g in jax.tree_util.tree_leaves(grads))


def test_optimizer_matches_optax_chain():
    rng = np.random.default_rng(7)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                                    params) for _ in range(5)]
    kw = dict(lr=1e-2, weight_decay=1e-2, lr_decay_rate=0.5, steps_per_epoch=2)
    opt = J.make_optimizer(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = opt.init(jp)
    state = T.init_train_state(params_from_jax(params, device="cpu"), T.make_optimizer(**kw))
    tensors = T.leaves(state.params)
    lrs = []
    for g in grads:
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gl in zip(tensors, T.leaves(params_from_jax(g, device="cpu"))):
            p.grad = gl
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    assert lrs == pytest.approx([1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3])
    for got, want in zip(tensors, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_the_step_never_calls_the_kernel_route(monkeypatch):
    """The train step differentiates apply_eager: pix_shuffle.apply (which
    sends bf16 on a card to K1, whose output has no gradient) and the K1
    wrapper are never called, and every parameter gets a gradient."""
    def refuse(*a, **kw):
        raise AssertionError("the train step reached the K1 route")

    monkeypatch.setattr(pix_shuffle, "apply", refuse)
    monkeypatch.setattr(fused_stack, "fused_stack_apply", refuse)
    m = get_model("pix_shuffle")
    state = T.init_train_state(m.init(torch.Generator().manual_seed(0), device="cpu"),
                               T.make_optimizer())
    before = [t.detach().clone() for t in T.leaves(state.params)]
    step = T.make_train_step(train_apply(m), build_criterion(m.loss, device="cpu"),
                             compute_dtype=torch.bfloat16)
    x = torch.rand(2, 1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    state, loss = step(state, x, x.flip(-2))
    assert torch.isfinite(loss)
    for p, b in zip(T.leaves(state.params), before):
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert not torch.equal(p.detach(), b)  # Adam moved every leaf


def test_mesh_raises_and_state_round_trip(devices8):
    """A BatchNorm model under sp (conv3 on a 1 x 2 mesh of gloo ranks, 2
    micro-batches of 4) gives JAX's step on its 1 x 2 mesh: the loss and the
    running stats within 1e-5, the parameters within 1e-5 and Adam's
    moments within 1e-4 relative (the slabs' statistics over their owned
    rows, all-reduced). Then the state's BN split and merge round trip."""
    from test_torch_parallel import _check_step, _jax_step, _step_worker

    from fs_uae_image_enhancer_project_tpu_torch.parallel.mesh import spawn_ranks

    jparams, lr, hr, loss, params, buffers, moments = _jax_step(
        "conv3", (2, 4, 16, 16, 3), 3, 2, 1e-3, n_devices=2)
    res = spawn_ranks(_step_worker, 2, ("conv3", jparams, lr, hr, 2, 1e-3, 2),
                      device="cpu", timeout=180.0)
    _check_step(res, loss, params, buffers, moments)
    # the 1 x 2 mesh without a process group is refused no more either
    mesh = Mesh(np.arange(2).reshape(1, 2), 0, torch.device("cpu"))
    T.make_train_step(train_apply(get_model("conv3")), lambda y, t: y.mean(),
                      has_batchnorm=True, mesh=mesh)
    m = get_model("conv5")
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    trainable, buffers = T.split_bn_buffers(params)
    jt, jb = J.split_bn_buffers(params_to_numpy(params))
    assert jax.tree_util.tree_structure(params_to_numpy(trainable)) == \
        jax.tree_util.tree_structure(jt)
    assert jax.tree_util.tree_structure(params_to_numpy(buffers)) == \
        jax.tree_util.tree_structure(jb)
    assert T.merge_bn_buffers(trainable, buffers) == params
    state = T.init_train_state(params, T.make_optimizer(), has_batchnorm=True)
    assert all(t.requires_grad for t in T.leaves(state.params))
    assert not any(t.requires_grad for t in T.leaves(state.buffers))
    assert state.params["conv1"]["w"] is not params["conv1"]["w"]  # a copy
