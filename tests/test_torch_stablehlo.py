"""The port's torch.export route against the JAX package's jax.export route,
on the CPU.

- K1 as the custom op ``torch.ops.fse.fused_stack``: its CPU implementation
  is the plain version (weights read back from the fragments bit for bit),
  its fake implementation gives the shape, and ``fused_stack`` records it
  when ``torch.export`` traces;
- ``export_enhance`` -> ``load_enhance`` gives the eager enhance byte for
  byte at 32x48 (JAX's ``test_stablehlo_export_roundtrip``) for pix_shuffle
  (through the fused stack, so the program holds the op) and conv3 (fused,
  sRGB domain), and is at least 50 dB from JAX's loaded ``jax.export``
  artifact on the same weights;
- ``stablehlo_text`` names the op once for pix_shuffle and never for conv3;
- ``load_enhance`` refuses a JAX artifact, any non-.pt2 file and another
  device type than the artifact's, with ``ValueError``.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import psnr
from fs_uae_image_enhancer_project_tpu.export import enhance as jax_enhance
from fs_uae_image_enhancer_project_tpu.export import stablehlo as jax_stablehlo
from fs_uae_image_enhancer_project_tpu.models import conv_stack as jax_conv_stack
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu_torch.export import stablehlo
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import make_enhance_fn
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import conv_stack
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

H, W = 32, 48
OP = "torch.ops.fse.fused_stack.default("


def _frame(seed=0, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 4), np.uint8)


def _enhances(family):
    """(port enhance on the CPU, JAX enhance) on the same weights: pix_shuffle
    through the fused stack (the route whose program holds K1's op), conv3
    fused in the sRGB domain, as the export CLIs build them."""
    jm = jax_model(family)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))
    if family == "conv3":
        tree = jax.tree_util.tree_map(np.asarray, jax_conv_stack.fuse(tree, jm.config))
        cfg = get_model("conv3").config
        port = make_enhance_fn(lambda p, x: conv_stack.apply_fused(p, x, cfg),
                               params_from_jax(tree, device="cpu"), crop_left=0,
                               srgb_domain=True, device="cpu")
        ref = jax_enhance.make_enhance_fn(
            lambda p, x: jax_conv_stack.apply_fused(p, x, jm.config), tree, crop_left=0,
            srgb_domain=True, donate=False, jit=False)
    else:
        port = make_enhance_fn(fs.fused_stack_apply, params_from_jax(tree, device="cpu"),
                               crop_left=0, device="cpu")
        ref = jax_enhance.make_enhance_fn(jm.apply, tree, crop_left=0, donate=False, jit=False)
    return port, ref


def test_op_cpu_and_fake_implementations():
    params = get_model("pix_shuffle").init(torch.Generator().manual_seed(3), device="cpu")
    sw = fs.prepare_weights(params, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(fs.plain_from_fragments(sw.frags), sw.plain))
    u = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 10, 14, 12))
                         .astype(np.float32)).bfloat16()
    with torch.no_grad():  # the op's kernels run below autograd
        got = torch.ops.fse.fused_stack(u, *sw.frags, sw.prm)
        assert torch.equal(got, fs.fused_stack_plain(u, sw))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = torch.ops.fse.fused_stack(mode.from_tensor(u),
                                         *(mode.from_tensor(f) for f in sw.frags),
                                         mode.from_tensor(sw.prm))
    assert fake.shape == u.shape and fake.dtype == torch.bfloat16


@pytest.mark.parametrize("family", ["pix_shuffle", "conv3"])
def test_export_roundtrip_is_the_eager_enhance(family, tmp_path):
    port, _ = _enhances(family)
    path = str(tmp_path / "enhance.pt2")
    assert stablehlo.export_enhance(port, path, frame_h=H, frame_w=W, device="cpu") == path
    assert sorted(os.listdir(tmp_path)) == ["enhance.pt2"]  # no temporary left
    assert stablehlo.artifact_meta(path) == {"device": "cpu", "shape": [1, H, W, 4]}
    loaded = stablehlo.load_enhance(path, device="cpu")
    for seed in (0, 1):
        frame = _frame(seed)
        got = loaded(frame)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (1, H, W, 4)
        assert torch.equal(got, port(frame))


@pytest.mark.parametrize("family", ["pix_shuffle", "conv3"])
def test_port_artifact_matches_jax_artifact(family, tmp_path):
    port, ref = _enhances(family)
    stablehlo.export_enhance(port, str(tmp_path / "p.pt2"), frame_h=H, frame_w=W, device="cpu")
    jax_stablehlo.export_enhance(ref, str(tmp_path / "j.jaxexport"), frame_h=H, frame_w=W)
    ours = stablehlo.load_enhance(str(tmp_path / "p.pt2"), device="cpu")
    theirs = jax_stablehlo.load_enhance(str(tmp_path / "j.jaxexport"))
    for seed in (2, 3):
        frame = _frame(seed)
        a = ours(frame).numpy()
        b = np.asarray(theirs(jnp.asarray(frame)))
        assert psnr(a[..., :3], b[..., :3]) >= 50.0
        np.testing.assert_array_equal(a[..., 3], b[..., 3])


def test_text_names_the_op_once():
    ps, _ = _enhances("pix_shuffle")
    c3, _ = _enhances("conv3")
    assert stablehlo.stablehlo_text(ps, frame_h=H, frame_w=W, device="cpu").count(OP) == 1
    text = stablehlo.stablehlo_text(c3, frame_h=H, frame_w=W, device="cpu")
    assert OP not in text and "aten.conv2d" in text
    # the served eager route on the CPU holds no op, and the direct call
    # outside a trace stays the plain version
    m = get_model("pix_shuffle")
    eager = make_enhance_fn(m.apply, m.init(torch.Generator().manual_seed(0), device="cpu"),
                            crop_left=0, device="cpu")
    assert OP not in stablehlo.stablehlo_text(eager, frame_h=H, frame_w=W, device="cpu")


def test_batch_and_full_frame_shape(tmp_path):
    port, _ = _enhances("conv3")
    path = str(tmp_path / "b.pt2")
    stablehlo.export_enhance(port, path, frame_h=H, frame_w=W, batch=2, device="cpu")
    frames = _frame(5, n=2)
    assert torch.equal(stablehlo.load_enhance(path, device="cpu")(frames), port(frames))


def test_load_refuses_other_formats_and_devices(tmp_path):
    _, ref = _enhances("conv3")
    jpath = str(tmp_path / "enhance.jaxexport")
    jax_stablehlo.export_enhance(ref, jpath, frame_h=H, frame_w=W)
    for path in (jpath, os.path.join(os.path.dirname(__file__), "..", "artifacts",
                                     "model_conv3", "conv3.onnx")):
        with pytest.raises(ValueError, match=r"torch\.export \(\.pt2\).*jax\.export"):
            stablehlo.load_enhance(path, device="cpu")
    port, _ = _enhances("conv3")
    path = str(tmp_path / "c.pt2")
    stablehlo.export_enhance(port, path, frame_h=H, frame_w=W, device="cpu")
    with pytest.raises(ValueError, match="exported on cpu"):
        stablehlo.load_enhance(path, device="cuda")
    with pytest.raises(ValueError, match="exported on cpu"):
        stablehlo.load_enhance(path)
