"""The port's parallel layer against the JAX package's, on the CPU.

The port's mesh is a grid of processes in one ``gloo`` group: each test that
needs one runs its ranks in 4 spawned processes (``spawn_ranks``, which kills
every child still alive past its timeout and fails), where the JAX tests use
8 virtual devices; the JAX side runs here on its 8-device CPU mesh, on the
same numpy inputs and weights.

- ``make_mesh``: shapes, the rank grid and the arithmetic errors;
  the shardings' blocks, ``replicate`` and the differentiable row gather;
  no jax in a rank's process; ``spawn_ranks`` raising at a failing rank and
  at its timeout, with no child left;
- the spatial split equal to the unsplit forward and to JAX's height-sharded
  forward (atol 2e-5, rtol 1e-5), pix_shuffle and conv6; one conv's worth
  of halo less is not;
- ``enhance_directory`` over dp = 4 ranks and the 1x1 mesh, 5 files (the
  padding path), fp32 compute: byte for byte JAX's ``enhance_directory``;
- a dp x sp = 2 x 2 pix_shuffle step (fp32, no VGG) against JAX's step on
  ``make_mesh(8, sp=2)``: the loss within 1e-5 relative, the parameters after
  one Adam step within 1e-5, and Adam's moments (0.1 g, 0.001 g^2) within
  1e-4 relative, which holds the gradient's size where the update holds its
  sign;
- conv3 under dp = 4 against JAX's BatchNorm setup: the loss, the parameters,
  Adam's moments and the BN running mean and var (statistics taken per rank
  would miss); and under dp 2 x sp 2, where each slab's statistics cover its
  owned rows only (a halo counted would miss);
- ``run_dryrun(4)``: a finite loss.

The worker functions live here at module level, so the spawned children
import this module: it imports no jax at the top.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from fs_uae_image_enhancer_project_tpu_torch.export.enhance import make_enhance_fn
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
from fs_uae_image_enhancer_project_tpu_torch.models import get_model, train_apply
from fs_uae_image_enhancer_project_tpu_torch.parallel import mesh as M
from fs_uae_image_enhancer_project_tpu_torch.parallel import spatial
from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as T
from fs_uae_image_enhancer_project_tpu_torch.parallel.dryrun import run_dryrun
from fs_uae_image_enhancer_project_tpu_torch.parallel.inference import (
    enhance_directory,
    make_sharded_enhance,
)

RANKS = 4
TIMEOUT = 180.0


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_without_a_process_group():
    mesh = M.make_mesh(device="cpu")
    assert mesh.devices.shape == (1, 1) and mesh.axis_names == ("dp", "sp")
    assert (mesh.rank, mesh.dp_index, mesh.sp_index) == (0, 0, 0)
    assert mesh.dp_group is mesh.sp_group is mesh.world_group is None
    with pytest.raises(ValueError, match="asked for 2 devices but only 1 are available"):
        M.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="sp=2 must divide"):
        M.make_mesh(1, sp=2, device="cpu")
    x = torch.arange(2 * 4 * 3).reshape(2, 4, 3, 1)
    assert torch.equal(M.batch_sharding(mesh)(x), x)
    assert torch.equal(M.shard_batch(mesh, {"a": x})["a"], x)
    assert torch.equal(M.replicate(mesh, {"p": {"w": x}})["p"]["w"], x)


def _mesh_worker():
    mesh = M.make_mesh(RANKS, sp=2, device="cpu")
    errors = {}
    for kw in (dict(n_devices=RANKS, sp=3), dict(n_devices=8), dict(n_devices=2),
               dict(n_devices=RANKS, dp=3)):
        try:
            M.make_mesh(**kw, device="cpu")
        except ValueError as e:
            errors[str(kw)] = str(e)
    x = torch.arange(4 * 8 * 2).reshape(4, 8, 2, 1).float()
    acc = torch.arange(2 * 4 * 8).reshape(2, 4, 8, 1)
    mine = M.replicate(mesh, {"w": torch.full((3,), float(mesh.rank))})["w"]
    # the row gather: forward concatenates the sp group's slabs, backward
    # hands this rank its own rows of the gradient
    y = torch.full((1, 2, 3, 1), float(mesh.rank), requires_grad=True)
    g = spatial.gather_rows(y, mesh)
    (g * torch.arange(4).reshape(1, 4, 1, 1)).sum().backward()
    jax_loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "fs_uae_image_enhancer_project_tpu")]
    return dict(shape=mesh.devices.shape, grid=mesh.devices.tolist(), rank=mesh.rank,
                jax_loaded=jax_loaded,
                index=(mesh.dp_index, mesh.sp_index), errors=errors,
                block=M.batch_sharding(mesh)(x).numpy(),
                accum_block=M.accum_batch_sharding(mesh)(acc).numpy(),
                replicated=mine.numpy(), gathered=g.detach().numpy()[0, :, 0, 0],
                grad=y.grad.numpy()[0, :, 0, 0])


def test_make_mesh_and_shardings_over_gloo():
    res = M.spawn_ranks(_mesh_worker, RANKS, device="cpu", timeout=TIMEOUT)
    x = np.arange(4 * 8 * 2).reshape(4, 8, 2, 1).astype(np.float32)
    acc = np.arange(2 * 4 * 8).reshape(2, 4, 8, 1)
    for r, out in enumerate(res):
        d, s = divmod(r, 2)
        assert out["shape"] == (2, 2) and out["grid"] == [[0, 1], [2, 3]]
        assert out["rank"] == r and out["index"] == (d, s)
        assert out["jax_loaded"] == []  # a rank's process runs the port alone
        errs = list(out["errors"].values())
        assert len(errs) == 4
        assert "sp=3 must divide device count 4" in errs[0]
        assert "asked for 8 devices but only 4 are available" in errs[1]
        assert "process group has 4 ranks" in errs[2]
        assert "dp*sp = 3 != 4 devices" in errs[3]
        np.testing.assert_array_equal(out["block"], x[2 * d:2 * d + 2, 4 * s:4 * s + 4])
        np.testing.assert_array_equal(out["accum_block"], acc[:, 2 * d:2 * d + 2, 4 * s:4 * s + 4])
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))
        # rank r's slab holds r; the sp group of rank r is [2d, 2d + 1]
        np.testing.assert_array_equal(out["gathered"], [2 * d, 2 * d, 2 * d + 1, 2 * d + 1])
        np.testing.assert_array_equal(out["grad"], [2 * s, 2 * s + 1])


def _failing_worker():
    if M.dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return 0


def test_spawn_ranks_stops_at_a_failure_and_at_its_timeout():
    import multiprocessing

    with pytest.raises(Exception, match="rank one fails"):
        M.spawn_ranks(_failing_worker, 2, device="cpu", timeout=TIMEOUT)
    assert not multiprocessing.active_children()
    # 2 s: the ranks are still starting, and are killed
    with pytest.raises(TimeoutError, match="did not finish in 2.0 s"):
        M.spawn_ranks(_failing_worker, 2, device="cpu", timeout=2.0)
    assert not multiprocessing.active_children()


# ---------------------------------------------------------------------------
# the spatial split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pix_shuffle", "conv6"])
def test_spatial_split_matches_unsplit_and_jax(name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
    from fs_uae_image_enhancer_project_tpu.parallel import make_mesh, replicate

    jm = jax_model(name)
    jparams = jm.init(jax.random.key(0))
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 48, 3)).astype(np.float32)
    mesh = make_mesh(8, dp=1, sp=8)
    bspec = NamedSharding(mesh, P(None, "sp"))
    want = np.asarray(jax.jit(jm.apply, in_shardings=(NamedSharding(mesh, P()), bspec))(
        replicate(mesh, jparams), jax.device_put(jnp.asarray(x), bspec)))

    m = get_model(name)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    halo = spatial.model_halo(m)
    assert halo == ((14, 2) if name == "pix_shuffle" else (7, 1))
    xt = torch.from_numpy(x)
    whole = m.apply(params, xt).numpy()
    for sp in (2, 4, 8):
        got = spatial.apply_split(m.apply, params, xt, sp=sp, halo=halo).numpy()
        np.testing.assert_allclose(got, whole, atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    # one conv's worth of halo less misses the tolerance
    short = spatial.Halo(halo.rows - halo.align, halo.align)
    got = spatial.apply_split(m.apply, params, xt, sp=8, halo=short).numpy()
    assert not np.allclose(got, whole, atol=2e-5, rtol=1e-5)


def test_spatial_split_rules():
    halo = spatial.model_halo(get_model("conv3"))
    assert halo == (3, 1)
    assert spatial.slab(48, 4, 0, halo) == (0, 12, 0, 15)
    assert spatial.slab(48, 4, 3, halo) == (36, 48, 33, 48)
    with pytest.raises(ValueError, match="does not split"):
        spatial.slab(50, 4, 0, spatial.Halo(14, 2))
    with pytest.raises(ValueError, match="triplet attention"):
        spatial.model_halo(get_model("residual_unet"))
    # the stack's residual adds and the long skip leave the radius at one row
    # a 3x3 conv: conv5 is five convs deep
    assert spatial.model_halo(get_model("conv5")) == (5, 1)


def test_sp_step_takes_its_halo_from_the_model():
    # a 1 x 2 mesh: no process group is needed to build the step
    mesh = M.Mesh(np.arange(2).reshape(1, 2), 0, torch.device("cpu"))
    criterion = lambda y, t: (y - t).abs().mean()  # noqa: E731
    with pytest.raises(ValueError, match="train_apply"):
        T.make_train_step(lambda p, x: x, criterion, mesh=mesh)
    T.make_train_step(train_apply(get_model("pix_shuffle")), criterion, mesh=mesh)


# ---------------------------------------------------------------------------
# sharded inference
# ---------------------------------------------------------------------------

def _enhance(jparams):
    m = get_model("pix_shuffle")
    return make_enhance_fn(m.apply, params_from_jax(jparams, device="cpu"), crop_left=0,
                           compute_dtype=torch.float32, device="cpu")


def _directory_worker(jparams, src, dst, frames):
    mesh = M.make_mesh(RANKS, device="cpu")
    enh = _enhance(jparams)
    sharded, shard_batch = make_sharded_enhance(enh, mesh)
    out = sharded(shard_batch(frames)).numpy()
    try:
        shard_batch(frames[:3])
        refused = None
    except ValueError as e:
        refused = str(e)
    n = enhance_directory(enh, src, dst, mesh=mesh, verbose=0)
    return dict(out=out, refused=refused, n=n)


def test_enhance_directory_matches_jax(devices8, tmp_path):
    import jax
    import jax.numpy as jnp
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu.export.enhance import make_enhance_fn as jax_make
    from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
    from fs_uae_image_enhancer_project_tpu.parallel import make_mesh
    from fs_uae_image_enhancer_project_tpu.parallel.inference import (
        enhance_directory as jax_directory,
    )

    jm = jax_model("pix_shuffle")
    jparams = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    jenh = jax_make(jm.apply, jparams, crop_left=0, donate=False, jit=False,
                    compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, 16, 32, 4), np.uint8)
    src = tmp_path / "in"
    src.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (16, 32, 4), np.uint8), mode="RGBA").save(
            src / f"f{i}.png")
    want_n = jax_directory(jenh, str(src), str(tmp_path / "jax"), mesh=make_mesh(8, sp=1),
                           verbose=0)
    want_frames = np.asarray(jax.jit(jenh)(jnp.asarray(frames)))

    res = M.spawn_ranks(_directory_worker, RANKS,
                        (jparams, str(src), str(tmp_path / "dp4"), frames),
                        device="cpu", timeout=TIMEOUT)
    for r, out in enumerate(res):
        assert out["n"] == want_n == 5
        assert out["refused"] == "batch 3 must be divisible by dp=4"
        np.testing.assert_array_equal(out["out"], want_frames[2 * r:2 * r + 2])
    # the 1x1 mesh in this process, two chunks of 3 (the second padded)
    n = enhance_directory(_enhance(jparams), str(src), str(tmp_path / "one"), batch_size=3,
                          mesh=M.make_mesh(device="cpu"), verbose=0)
    assert n == 5
    for out_dir in ("dp4", "one"):
        assert sorted(os.listdir(tmp_path / out_dir)) == sorted(os.listdir(tmp_path / "jax"))
        for name in os.listdir(tmp_path / "jax"):
            with Image.open(tmp_path / out_dir / name) as a, \
                    Image.open(tmp_path / "jax" / name) as b:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _step_worker(name, jparams, lr, hr, sp, learning_rate, ranks=RANKS):
    mesh = M.make_mesh(ranks, sp=sp, device="cpu")
    m = get_model(name)
    has_bn = name != "pix_shuffle"
    state = T.init_train_state(M.replicate(mesh, params_from_jax(jparams, device="cpu")),
                               T.make_optimizer(lr=learning_rate), has_batchnorm=has_bn)
    criterion = build_criterion(dataclasses.replace(m.loss, vgg_weight=0.0), device="cpu")
    step = T.make_train_step(train_apply(m), criterion, has_batchnorm=has_bn,
                             compute_dtype=torch.float32, mesh=mesh)
    take = M.accum_batch_sharding(mesh)
    new, loss = step(state, take(torch.from_numpy(lr)), take(torch.from_numpy(hr)))
    # Adam's moments after one step: 0.1 g and 0.001 g^2 of the all-reduced
    # gradient (with the decay term), its size where the update holds only
    # its sign
    moments = {k: M._tree_map(lambda p: new.optimizer.state[p][k], new.params)
               for k in ("exp_avg", "exp_avg_sq")}
    return float(loss), _numpy(new.params), _numpy(new.buffers), _numpy(moments)


def _jax_step(name, shape, seed, sp, learning_rate, n_devices=8):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fs_uae_image_enhancer_project_tpu.losses.perceptual import build_criterion as jc
    from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
    from fs_uae_image_enhancer_project_tpu.parallel import (
        init_train_state, make_mesh, make_optimizer, make_train_step, replicate)

    jm = jax_model(name)
    has_bn = name != "pix_shuffle"
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 1, shape).astype(np.float32)
    hr = rng.uniform(0, 1, shape).astype(np.float32)
    mesh = make_mesh(n_devices, sp=sp)
    opt = make_optimizer(lr=learning_rate)
    step = jax.jit(make_train_step(jm.apply, jc(dataclasses.replace(jm.loss, vgg_weight=0.0)),
                                   opt, has_batchnorm=has_bn, compute_dtype=jnp.float32,
                                   mesh=mesh))
    state = replicate(mesh, init_train_state(params, opt, has_batchnorm=has_bn))
    bspec = NamedSharding(mesh, P(None, "dp", "sp"))
    new, loss = step(state, jax.device_put(jnp.asarray(lr), bspec),
                     jax.device_put(jnp.asarray(hr), bspec))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    adam = next(s for s in new.opt_state if hasattr(s, "mu"))
    moments = {"exp_avg": _flat(as_np(adam.mu)), "exp_avg_sq": _flat(as_np(adam.nu))}
    return (as_np(params), lr, hr, float(loss), _flat(as_np(new.params)),
            _flat(as_np(new.buffers)), moments)


def _check_step(res, want_loss, want_params, want_buffers, want_moments):
    for loss, params, buffers, moments in res:
        for name, want in want_moments.items():
            # relative to each leaf's largest moment: a gradient off by a
            # constant factor (a dp division missed or doubled) fails here
            got = _flat(moments[name])
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5 * np.abs(v).max(),
                                           err_msg=f"{name} {k}")
        assert loss == pytest.approx(want_loss, rel=1e-5)
        got = _flat(params)
        assert sorted(got) == sorted(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)
        got = _flat(buffers)
        assert sorted(got) == sorted(want_buffers)
        for k, v in want_buffers.items():
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0, err_msg=k)


def test_dp_sp_train_step_matches_jax(devices8):
    """pix_shuffle at 16x16, fp32, no VGG: JAX on dp 4 x sp 2 devices, the
    port on dp 2 x sp 2 processes, the same global batch of 4."""
    jparams, lr, hr, loss, params, buffers, moments = _jax_step(
        "pix_shuffle", (1, 4, 16, 16, 3), 0, 2, 3e-4)
    res = M.spawn_ranks(_step_worker, RANKS, ("pix_shuffle", jparams, lr, hr, 2, 3e-4),
                        device="cpu", timeout=TIMEOUT)
    _check_step(res, loss, params, buffers, moments)
    # Adam moved every parameter: the step was not a no-op
    start = _flat(jparams)
    assert all(np.abs(v - start[k]).max() > 1e-5 for k, v in params.items())


def test_dp_batchnorm_statistics_match_jax(devices8):
    """conv3 (BatchNorm) as JAX's BatchNorm mesh test sets it up (batch of
    8, 2 micro-batches), the port on dp = 4: the running stats are the global
    batch's on every rank."""
    jparams, lr, hr, loss, params, buffers, moments = _jax_step("conv3", (2, 8, 16, 16, 3), 1,
                                                                1, 1e-3)
    res = M.spawn_ranks(_step_worker, RANKS, ("conv3", jparams, lr, hr, 1, 1e-3),
                        device="cpu", timeout=TIMEOUT)
    assert sorted({k.split(".")[0] for k in buffers}) == ["bn1", "bn2", "bn3"]
    _check_step(res, loss, params, buffers, moments)


def test_sp_batchnorm_statistics_match_jax(devices8):
    """conv3 (BatchNorm) on JAX's dp 4 x sp 2 mesh and the port's dp 2 x
    sp 2 ranks, the same global batch of 8 in 2 micro-batches: each slab
    takes its statistics over its owned rows (a 3-row halo each side of 8)
    all-reduced over the whole mesh, so the running stats, the loss, the
    parameters and Adam's moments are the global batch's, as in JAX."""
    jparams, lr, hr, loss, params, buffers, moments = _jax_step("conv3", (2, 8, 16, 16, 3), 2,
                                                                2, 1e-3)
    res = M.spawn_ranks(_step_worker, RANKS, ("conv3", jparams, lr, hr, 2, 1e-3),
                        device="cpu", timeout=TIMEOUT)
    assert sorted({k.split(".")[0] for k in buffers}) == ["bn1", "bn2", "bn3"]
    _check_step(res, loss, params, buffers, moments)


def test_dryrun_four_ranks():
    loss = run_dryrun(RANKS, timeout=TIMEOUT)
    assert np.isfinite(loss) and loss > 0
