"""The port's int8 PTQ/QAT path and bench lock against the JAX package, on
the CPU.

- ``quantize_weight`` gives JAX's int8 weights and scales; ``_qconv``'s
  int8 codes are JAX's byte for byte (fp32 and bf16 inputs, the scale
  rounded to the input's dtype first as JAX's weak type does) and its
  dequantized fp32 output is within 1e-6 relative; the im2col padding for
  ``torch._int_mm`` (K = 27, 108, 648 to multiples of 8) keeps the integer
  sums exact;
- ``calibrate`` and ``calibrate_conv_stack`` give JAX's scales within 1e-6
  relative; ``apply_fused_int8`` is within 2e-5 of the fake-quant forward
  (JAX's own bound, ``tests/test_qat.py``); ``make_quantized_enhance`` is
  within one level of JAX's at fp32 and at least 50 dB from it at bf16;
- the STE gradient; five fp32 distillation steps against JAX's
  ``qat_distill_conv_stack`` (the loss within 1e-5 relative, the parameters
  within 1e-5 where the first step's |g| >= 1e-7: Adam's first step is
  lr g / (|g| + 1e-8));
- the bench lock (``tests/test_platform_guard.py``'s case). The int8 study
  and ``chip_smoke.py``'s int8 phase are rehearsed in
  ``test_torch_int8_rehearsal.py``.
"""
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import psnr
from fs_uae_image_enhancer_project_tpu.export import qat as jqat
from fs_uae_image_enhancer_project_tpu.export import quantized as jq
from fs_uae_image_enhancer_project_tpu.models import conv_stack as jax_conv_stack
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.models.configs import ConvStackConfig as JaxConvStackConfig
from fs_uae_image_enhancer_project_tpu_torch.export import qat
from fs_uae_image_enhancer_project_tpu_torch.export import quantized as q
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.models.configs import ConvStackConfig

CFG = ConvStackConfig(channels=(8, 16, 3), kernel_size=3, residual_layers=(), final_act="none")
JCFG = JaxConvStackConfig(channels=(8, 16, 3), kernel_size=3, residual_layers=(),
                          final_act="none")


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stack_params(seed=0, cfg=JCFG):
    """JAX's fused conv-stack parameters (numpy) and the port's (CPU)."""
    tree = _tree(jax_conv_stack.fuse(jax_conv_stack.init(jax.random.key(seed), cfg), cfg))
    return tree, params_from_jax(tree, device="cpu")


def _frames(n=2, hw=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("cin,dtype", [(3, "float32"), (12, "float32"), (72, "float32"),
                                       (3, "bfloat16"), (12, "bfloat16"), (72, "bfloat16")])
def test_qconv_codes_and_output_match_jax(cin, dtype):
    rng = np.random.default_rng(cin)
    x = rng.normal(0, 1, (2, 9, 11, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, cin, 5)).astype(np.float32)
    b = rng.normal(0, 0.1, (5,)).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0 * 0.9  # some codes clip
    jqp = jq.quantize_weight({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tqp = q.quantize_weight({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    np.testing.assert_array_equal(tqp["w_q"].numpy(), np.asarray(jqp["w_q"]))
    np.testing.assert_array_equal(tqp["w_scale"].numpy(), np.asarray(jqp["w_scale"]))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want_codes = np.asarray(jnp.clip(jnp.round(xj / scale), -127, 127).astype(jnp.int8))
    codes = q.quantize_act(xt, scale)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    got = q._qconv(tqp, xt, scale)
    assert got.dtype == xt.dtype
    want = np.asarray(jq._qconv(jqp, xj, scale).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the bf16 quotient differs from torch's unrounded-scale division
    # somewhere, so the rounding rule is load-bearing
    if dtype == "bfloat16":
        naive = torch.round(xt / scale).clamp(-127, 127).to(torch.int8).numpy()
        assert (naive != want_codes).any()


@pytest.mark.parametrize("cin", [3, 12, 72])  # K = 27, 108, 648
def test_im2col_padding_keeps_the_integer_sums(cin):
    rng = np.random.default_rng(cin)
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 7, 9, cin), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, 12), dtype=np.int8))
    cols = q.im2col(xq, 3, 3)
    assert cols.shape == (2 * 7 * 9, -(-9 * cin // 8) * 8) and cols.dtype == torch.int8
    assert not cols[:, 9 * cin:].any()
    acc = q.qconv_acc(w_q, xq)
    want = torch.nn.functional.conv2d(xq.permute(0, 3, 1, 2).double(),
                                      w_q.permute(3, 2, 0, 1).double(), padding=1)
    assert acc.dtype == torch.int32
    assert torch.equal(acc.long(), want.permute(0, 2, 3, 1).round().long())
    # 6 rows (padded to 32 for cuBLASLt) and an even kernel (XLA's SAME split)
    one = q.qconv_acc(w_q, xq[:1, :2, :3])
    j = jax.lax.conv_general_dilated(jnp.asarray(xq[:1, :2, :3].numpy()), jnp.asarray(w_q.numpy()),
                                     (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(one.numpy(), np.asarray(j))
    w2 = w_q[:2, :2]
    j2 = jax.lax.conv_general_dilated(jnp.asarray(xq.numpy()), jnp.asarray(w2.contiguous().numpy()),
                                      (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                      preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(q.qconv_acc(w2.contiguous(), xq).numpy(), np.asarray(j2))


def test_calibrate_scales_match_jax():
    jm = jax_model("pix_shuffle")
    tree = _tree(jm.init(jax.random.key(0)))
    frames = [np.random.default_rng(i).uniform(0, 1, (24, 32, 3)).astype(np.float32) ** 2.2
              for i in range(2)]
    want = jq.calibrate(tree, jm.config, frames)
    got = q.calibrate(params_from_jax(tree, device="cpu"), get_model("pix_shuffle").config,
                      frames)
    assert list(got) == list(want) == q.CONV_ORDER
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    tree, params = _stack_params()
    frames = _frames()
    want = jqat.calibrate_conv_stack(tree, JCFG, frames)
    got = qat.calibrate_conv_stack(params, CFG, frames)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_fakequant_matches_int8_deployment_and_jax():
    tree, params = _stack_params()
    frames = _frames()
    scales = qat.calibrate_conv_stack(params, CFG, frames)
    x = torch.from_numpy(frames[0])
    y_fake = qat.apply_fused_fakequant(params, x, CFG, scales)
    y_int8 = qat.apply_fused_int8(qat.quantize_conv_stack(params), x, CFG, scales)
    np.testing.assert_allclose(y_fake.detach().numpy(), y_int8.numpy(), atol=2e-5)
    jy = np.asarray(jqat.apply_fused_int8(jqat.quantize_conv_stack(tree), jnp.asarray(frames[0]),
                                          JCFG, scales))
    np.testing.assert_allclose(y_int8.numpy(), jy, rtol=1e-5, atol=1e-6)


def test_int8_path_respects_residual_and_sigmoid():
    jcfg = JaxConvStackConfig(channels=(6, 6, 3), kernel_size=3, residual_layers=(1,),
                              final_act="sigmoid")
    cfg = ConvStackConfig(channels=(6, 6, 3), kernel_size=3, residual_layers=(1,),
                          final_act="sigmoid")
    tree, params = _stack_params(1, jcfg)
    frames = _frames(seed=3)
    for rbra in (False, True):
        scales = qat.calibrate_conv_stack(params, cfg, frames, relu_before_residual_add=rbra)
        want = jqat.calibrate_conv_stack(tree, jcfg, frames, relu_before_residual_add=rbra)
        assert all(scales[k] == pytest.approx(want[k], rel=1e-6) for k in want)
        x = torch.from_numpy(frames[0])
        y8 = qat.apply_fused_int8(qat.quantize_conv_stack(params), x, cfg, scales,
                                  relu_before_residual_add=rbra)
        j8 = np.asarray(jqat.apply_fused_int8(jqat.quantize_conv_stack(tree),
                                              jnp.asarray(frames[0]), jcfg, scales,
                                              relu_before_residual_add=rbra))
        np.testing.assert_allclose(y8.numpy(), j8, rtol=1e-5, atol=1e-6)
        assert 0.0 <= float(y8.min()) and float(y8.max()) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_quantized_enhance_matches_jax(dtype):
    jm = jax_model("pix_shuffle")
    tree = _tree(jm.init(jax.random.key(0)))
    calib = [np.random.default_rng(i).uniform(0, 1, (24, 32, 3)).astype(np.float32) ** 2.2
             for i in range(2)]
    ours = q.make_quantized_enhance(params_from_jax(tree, device="cpu"),
                                    get_model("pix_shuffle").config, calib,
                                    compute_dtype=getattr(torch, dtype), device="cpu")
    theirs = jq.make_quantized_enhance(tree, jm.config, calib,
                                       compute_dtype=getattr(jnp, dtype), jit=False)
    frames = np.random.default_rng(5).integers(0, 256, (2, 32, 48, 4), np.uint8)
    a = ours(frames).numpy()
    b = np.asarray(theirs(jnp.asarray(frames)))
    assert a.shape == b.shape == (2, 32, 48, 4)
    np.testing.assert_array_equal(a[..., 3], b[..., 3])
    if dtype == "float32":
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    else:
        assert psnr(a[..., :3], b[..., :3]) >= 50.0


def test_ste_gradient_is_the_identity():
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 3, 4, 8)).astype(np.float32))
    w.requires_grad_(True)
    (qat.fq_weight(w) * 2.0).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), 2.0, atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 5, 5, 4)).astype(np.float32))
    x.requires_grad_(True)
    (qat.fq_act(x, 0.01) * 2.0).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2.0, atol=1e-6)
    # the value path quantizes: JAX's fake-quant values
    np.testing.assert_allclose(qat.fq_weight(w).detach().numpy(),
                               np.asarray(jqat.fq_weight(jnp.asarray(w.detach().numpy()))),
                               rtol=1e-6, atol=1e-7)


def test_distillation_matches_jax():
    tree, params = _stack_params()
    batches = [np.concatenate(_frames(2, 16, seed=s)) for s in range(3)]
    scales = jqat.calibrate_conv_stack(tree, JCFG, batches)
    jtrained, _, jcurve = jqat.qat_distill_conv_stack(tree, JCFG, batches, steps=5, lr=2e-5,
                                                      act_scales=scales, verbose=0)
    trained, got_scales, curve = qat.qat_distill_conv_stack(params, CFG, batches, steps=5,
                                                            lr=2e-5, act_scales=scales,
                                                            verbose=0)
    assert got_scales == scales and len(curve) == 5
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)

    def loss(p, x):
        y_t = jax_conv_stack.apply_fused(tree, x, JCFG)
        y_s = jqat.apply_fused_fakequant(p, x, JCFG, scales)
        return jnp.mean(jnp.sqrt((y_s - y_t) ** 2 + 1e-6**2))

    g = _tree(jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(batches[0])))
    for name in tree:
        for leaf in tree[name]:
            got = trained[name][leaf].numpy()
            want = np.asarray(jtrained[name][leaf])
            mask = np.abs(g[name][leaf]) >= 1e-7
            assert mask.any()
            np.testing.assert_allclose(got[mask], want[mask], atol=1e-5, rtol=0)
            assert not np.array_equal(got, tree[name][leaf])  # it trained


def test_bench_lock(tmp_path):
    """The port's counterpart of tests/test_platform_guard.py's lock test:
    no lock and a dead pid return at once, a live holder blocks until it
    exits, a holder that stays raises TimeoutError; registering writes this
    process's pid once the lock is free."""
    from fs_uae_image_enhancer_project_tpu_torch.utils import platform as plat

    lock = str(tmp_path / "bench.lock")
    plat.wait_for_bench_lock(lockfile=lock, timeout_s=1.0, poll_s=0.05)
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    with open(lock, "w") as f:
        f.write(str(child.pid))
    plat.wait_for_bench_lock(lockfile=lock, timeout_s=1.0, poll_s=0.05)
    holder = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(1.0)"])
    with open(lock, "w") as f:
        f.write(str(holder.pid))
    t0 = time.monotonic()
    plat.wait_for_bench_lock(lockfile=lock, timeout_s=30.0, poll_s=0.05)
    waited = time.monotonic() - t0
    holder.wait()
    assert waited >= 0.5
    holder2 = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        with open(lock, "w") as f:
            f.write(str(holder2.pid))
        with pytest.raises(TimeoutError):
            plat.wait_for_bench_lock(lockfile=lock, timeout_s=0.3, poll_s=0.05)
    finally:
        holder2.kill()
        holder2.wait()
    with open(lock, "w") as f:
        f.write("not a pid")
    pidfile = str(tmp_path / "trainer.pid")
    plat.register_preemptible_pid(pidfile, lockfile=lock)
    with open(pidfile) as f:
        assert int(f.read()) == __import__("os").getpid()
    assert plat.BENCH_LOCKFILE != "/tmp/tpu_bench.lock"
