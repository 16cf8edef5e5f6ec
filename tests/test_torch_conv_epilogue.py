"""``conv2d``'s epilogue: the bias, an activation, a residual add and an
activation after a convolution (``ops/cuda/conv_epilogue.py``).

On the CPU (the plain path): ``conv2d``'s epilogue arguments give today's
composition bit for bit (``conv2d`` with its bias, ``apply_activation``, the
add), the residual block folds only identity and relu slots, and the
wrapper's helpers. On a card (marker ``gpu``; skips without one): the kernel
against its plain version bit for bit, what it refuses, and the heavyweight
residual U-Net's forward through it against the eager chain. The file
imports neither jax nor the JAX package, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest tests/test_torch_conv_epilogue.py -q --noconftest -p no:cacheprovider
"""
import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fs_uae_image_enhancer_project_tpu_torch.models import blocks, residual_unet
from fs_uae_image_enhancer_project_tpu_torch.models.configs import act
from fs_uae_image_enhancer_project_tpu_torch.ops import conv as conv_mod
from fs_uae_image_enhancer_project_tpu_torch.ops.activations import apply_activation
from fs_uae_image_enhancer_project_tpu_torch.ops.conv import conv2d, init_conv
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import conv_epilogue as ce

ACTS = ("identity", "relu")
# the residual: none, a tensor, a projection's raw output and its fp32 bias
RESIDUALS = ("none", "residual", "projection")
COMBOS = list(itertools.product(ACTS, ACTS, RESIDUALS))
DTYPES = (torch.bfloat16, torch.float32)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _rand(shape, seed: int, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=_gen(seed)) * scale


# ---------------------------------------------------------------------------
# the plain path (CPU)
# ---------------------------------------------------------------------------

def _conv_case(dtype, residual: str, device="cpu", cin=5, cout=7, hw=(6, 9)):
    """A 3x3 conv with its bias, an input, and the residual operands: the
    block's identity, or a 1x1 projection of it (weights and bias)."""
    params = {k: v.to(device) for k, v in init_conv(cin, cout, 3, generator=_gen(1)).items()}
    x = _rand((2, *hw, cin), 2).to(device, dtype)
    z = _rand((2, *hw, cout if residual == "residual" else 4), 3).to(device, dtype)
    proj = {k: v.to(device) for k, v in init_conv(4, cout, 1, generator=_gen(4)).items()}
    return params, x, z, proj


def _composition(params, x, pre, post, residual, z, proj):
    """Today's composition: ``conv2d`` with its bias, ``apply_activation``,
    the residual (a projection with its bias) added, ``apply_activation``."""
    y = apply_activation(pre, {}, conv2d(params, x), {})
    if residual == "residual":
        y = z + y
    elif residual == "projection":
        y = conv2d(proj, z) + y
    return apply_activation(post, {}, y, {})


def _slots(*names):
    """Parameter-free activation slots, as ``conv2d`` takes them."""
    return [(act(name), {}) for name in names]


def _epilogue(params, x, pre, post, residual, z, proj):
    pre, post = _slots(pre), _slots(post)
    if residual == "none":
        return conv2d(params, x, pre=pre, post=post)
    if residual == "residual":
        return conv2d(params, x, pre=pre, post=post, residual=z)
    return conv2d(params, x, pre=pre, post=post, residual=conv2d({"w": proj["w"]}, z),
                  residual_bias=proj["b"])


# (pre slots, post slots): what folds, what does not, and both in one call
SLOT_CASES = {
    "relu_relu": (("relu", "relu"), ()),
    "mish_relu": (("mish", "relu"), ()),
    "relu_mish": (("identity", "relu"), ("mish",)),
    "gelu_silu": (("gelu",), ("relu", "silu")),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
@pytest.mark.parametrize("residual", RESIDUALS)
def test_conv2d_slots_fold_or_run_eager_in_order(case, residual):
    """Identity and ReLU slots fold into the epilogue; any other activation
    runs as an op of its own where its slot is, with the same bits as the
    composition."""
    pre, post = SLOT_CASES[case]
    params, x, z, proj = _conv_case(torch.bfloat16, residual)
    want = conv2d(params, x)
    for name in pre:
        want = apply_activation(name, {}, want, {})
    if residual == "residual":
        want = z + want
    elif residual == "projection":
        want = conv2d(proj, z) + want
    for name in post:
        want = apply_activation(name, {}, want, {})
    kw = dict(pre=_slots(*pre), post=_slots(*post))
    if residual == "residual":
        kw.update(residual=z)
    elif residual == "projection":
        kw.update(residual=conv2d({"w": proj["w"]}, z), residual_bias=proj["b"])
    assert torch.equal(conv2d(params, x, **kw), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp32"))
@pytest.mark.parametrize("pre,post,residual", COMBOS)
def test_conv2d_epilogue_equals_composition(dtype, pre, post, residual):
    params, x, z, proj = _conv_case(dtype, residual)
    want = _composition(params, x, pre, post, residual, z, proj)
    got = _epilogue(params, x, pre, post, residual, z, proj)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("residual", RESIDUALS)
def test_conv2d_epilogue_records_gradients(residual):
    """With grad on, the eager chain runs and its gradients are the
    composition's."""
    def grads(fn):
        params, x, z, proj = _conv_case(torch.float32, residual)
        leaves = [params["w"], params["b"], proj["w"], proj["b"], x]
        for t in leaves:
            t.requires_grad_(True)
        fn(params, x, "relu", "relu", residual, z, proj).square().sum().backward()
        return [t.grad for t in leaves]

    for a, b in zip(grads(_composition), grads(_epilogue)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_conv2d_without_bias_or_epilogue_is_the_bare_conv():
    params, x, _z, _p = _conv_case(torch.bfloat16, "none")
    bare = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), params["w"].to(x.dtype).permute(3, 2, 0, 1), padding=1)
    assert torch.equal(conv2d({"w": params["w"]}, x), bare.permute(0, 2, 3, 1))


def _block_eager(p, x, acts, mid, out):
    """The residual block as it was before the epilogue: every activation and
    the residual add an op of its own, the projection with its bias."""
    acts = blocks.resolve_block_acts(acts, mid, out)
    identity = x
    x = conv2d(p["conv1"], x)
    x = conv2d(p["conv2"], x)
    x = apply_activation(acts[0][0], p["act1"], x, dict(acts[0][1]))
    x = apply_activation(acts[1][0], p["act2"], x, dict(acts[1][1]))
    x = conv2d(p["conv3"], x)
    x = apply_activation(acts[2][0], p["act3"], x, dict(acts[2][1]))
    if "proj" in p:
        identity = conv2d(p["proj"], identity)
    return apply_activation(acts[3][0], p["act4"], identity + x, dict(acts[3][1]))


UNET_ACTS = (act("identity"), act("relu"), act("relu"), act("identity"))
MISH1 = (act("mish"), act("relu"), act("relu"), act("identity"))
MISH4 = (act("identity"), act("relu"), act("relu"), act("mish"))
# (acts, the activations run as ops of their own, the epilogues that have
# something to do as (pre, post, residual)): conv1's bias, conv2's, conv3's
BLOCK_CASES = {
    "unet": (UNET_ACTS, [], [("identity", "identity", False), ("relu", "identity", False),
                             ("relu", "identity", True)]),
    "default": (blocks.DEFAULT_BLOCK_ACTS, [],
                [("identity", "identity", False), ("relu", "identity", False),
                 ("identity", "relu", True)]),
    # conv2's pass adds the bias alone; mish and relu follow as ops
    "mish_act1": (MISH1, ["mish", "relu"],
                  [("identity", "identity", False), ("identity", "identity", False),
                   ("relu", "identity", True)]),
    # conv3's pass stops at the residual; mish follows as an op
    "mish_act4": (MISH4, ["mish"], [("identity", "identity", False), ("relu", "identity", False),
                                    ("relu", "identity", True)]),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
@pytest.mark.parametrize("cin", (8, 12), ids=("identity", "projection"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp32"))
def test_feature_block_folds_identity_and_relu_slots(monkeypatch, case, cin, dtype):
    acts, eager, epilogues = BLOCK_CASES[case]
    p = blocks.init_feature_block(cin, 12, 8, 3, acts, generator=_gen(5), device="cpu")
    x = _rand((2, 6, 10, cin), 6).to(dtype)
    want = _block_eager(p, x, acts, 12, 8)
    ran, passes = [], []

    def activation(name, *args):
        ran.append(name)
        return apply_activation(name, *args)

    def plain(y, b=None, **kw):
        if ce.mode_of(b, kw.get("pre", "identity"), kw.get("post", "identity"),
                      kw.get("residual"), kw.get("residual_bias")):
            passes.append((kw.get("pre", "identity"), kw.get("post", "identity"),
                           kw.get("residual") is not None))
        return ce.epilogue_plain(y, b, **kw)

    monkeypatch.setattr(conv_mod, "apply_activation", activation)
    monkeypatch.setattr(conv_mod, "epilogue_plain", plain)
    got = blocks.apply_feature_block(p, x, acts, 12, 8)
    assert torch.equal(got, want)
    assert ran == eager
    # the projection's conv runs without its bias, which conv3's epilogue adds
    assert passes == epilogues


def test_unet_final_relu_folds_into_dec_final(monkeypatch):
    cfg = residual_unet.lightweight_config()
    p = residual_unet.init(cfg, _gen(7), device="cpu")
    x = _rand((1, 16, 24, 3), 8).abs()
    calls = []

    def recording(params, t, **kw):
        calls.append((params, kw))
        return conv2d(params, t, **kw)

    monkeypatch.setattr(residual_unet, "conv2d", recording)
    y = residual_unet.apply(p, x, cfg)
    assert [kw for params, kw in calls if params is p["dec_final"]] == [dict(post=_slots("relu"))]
    assert float(y.min()) >= 0.0


def test_conv_epilogue_on_cpu_is_the_plain_version():
    y = _rand((2, 3, 5, 36), 9).to(torch.bfloat16)
    b, r, bp = _rand((36,), 10), _rand((2, 3, 5, 36), 11).to(torch.bfloat16), _rand((36,), 12)
    want = ce.epilogue_plain(y.clone(), b, pre="relu", post="relu", residual=r, residual_bias=bp)
    before = ce.conv_epilogue.launches
    got = ce.conv_epilogue(y.clone(), b, pre="relu", post="relu", residual=r, residual_bias=bp)
    assert torch.equal(got, want) and ce.conv_epilogue.launches == before


@pytest.mark.parametrize("kw,msg", [
    (dict(pre="mish"), "activations"),
    (dict(post="gelu"), "activations"),
    (dict(residual_bias=torch.zeros(4)), "needs a residual"),
])
def test_epilogue_refuses_what_it_has_no_mode_for(kw, msg):
    """The kernel and its plain version refuse an activation they do not
    have (``conv2d`` runs such a slot as an op of its own) and a residual
    bias without a residual, as ``conv2d`` does."""
    y = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError, match=msg):
        ce.conv_epilogue(y, torch.zeros(4), **kw)
    with pytest.raises(ValueError, match=msg):
        ce.epilogue_plain(y, torch.zeros(4), **kw)
    if "residual_bias" in kw:
        with pytest.raises(ValueError, match=msg):
            conv2d({"w": torch.zeros(1, 1, 4, 4), "b": torch.zeros(4)}, y, **kw)


def test_mode_bits_and_refusal_off_the_card():
    assert ce.mode_of(None, "identity", "identity", None, None) == 0
    assert ce.mode_of(torch.zeros(3), "relu", "identity", None, None) == ce.BIAS | ce.PRE
    r = torch.zeros(3)
    assert ce.mode_of(None, "identity", "relu", r, r) == ce.POST | ce.RES | ce.RES_BIAS
    assert "card" in ce.refusal(torch.zeros(2, 3))


def test_layouts_the_kernel_takes():
    """Dense outputs only: NHWC (channels innermost, the vectorized path)
    and the NCHW memory cuDNN writes for an input whose strides are no NHWC
    tensor's, where the channel of offset i is (i // (H * W)) % C."""
    nhwc = torch.zeros(2, 4, 6, 36)
    nchw = torch.zeros(2, 36, 4, 6).permute(0, 2, 3, 1)
    assert ce._dense(nhwc) and ce.channel_stride(nhwc) == 1
    assert ce._dense(nchw) and ce.channel_stride(nchw) == 24
    # the formula the kernel uses, on every offset
    offsets = torch.arange(nchw.numel()).reshape(2, 36, 4, 6).permute(0, 2, 3, 1)
    channels = torch.arange(36).expand(2, 4, 6, 36)
    assert torch.equal(offsets // 24 % 36, channels)
    assert ce._dense(nhwc.transpose(1, 2)) and ce.channel_stride(nhwc.transpose(1, 2)) == 1
    assert not ce._dense(nhwc[:, :, ::2]) and not ce._dense(nhwc[..., :35])
    assert not ce._dense(torch.zeros(1, 1, 1, 36).expand(2, 4, 6, 36))
    assert ce.channel_stride(torch.zeros(2, 1, 4, 6).permute(0, 2, 3, 1)) == 1


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12fse_epilogue15epilogue_kernelIfLi5EEEvPT_PKS1_PKfS6_xi' for 'sm_90a'
ptxas info    : Function properties for _ZN12fse_epilogue15epilogue_kernelIfLi5EEEvPT_PKS1_PKfS6_xi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 388 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9fse_stack12stack_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN9fse_stack12stack_kernelEv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12fse_epilogue15epilogue_kernelI13__nv_bfloat16Li29EEEvPT_PKS2_PKfS7_xi' for 'sm_90a'
ptxas info    : Function properties for _ZN12fse_epilogue15epilogue_kernelI13__nv_bfloat16Li29EEEvPT_PKS2_PKfS7_xi
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 388 bytes cmem[0]
"""


def test_ptxas_report_reads_only_the_epilogue_kernels():
    assert ce.ptxas_report(PTXAS_LOG) == dict(kernels=2, max_registers=40, spill_bytes=8)
    assert ce.ptxas_report("") == dict(kernels=0, max_registers=0, spill_bytes=0)


def test_chip_smoke_epilogue_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's epilogue phase at small shapes on the CPU, where both
    sides are the plain version (CPU times, never device times)."""
    import time

    import chip_smoke as cs

    def wall_ms(fn, n=50, warmup=10):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    monkeypatch.setattr(cs, "median_ms", wall_ms)
    cases = [(name, (1, 6, 10, shape[-1]), acts, res) for name, shape, acts, res in cs.EPILOGUE_CASES]
    rec = cs.epilogue_phase(torch.device("cpu"), cases)
    cs.check_epilogue(rec, torch.device("cpu"))
    assert [c["case"] for c in rec["cases"]] == ["conv2", "conv3", "conv3_proj"]
    assert [c["bytes"] for c in rec["cases"]] == [2 * 2 * 60 * 108 + 4 * 108,
                                                  3 * 2 * 60 * 72 + 4 * 72,
                                                  3 * 2 * 60 * 72 + 8 * 72]
    assert all(c["kernel_ms"] > 0 and c["library_ms"] > 0 for c in rec["cases"])
    assert rec["ptxas"] is None


@pytest.mark.parametrize("family", ("conv3", "conv3_heavy", "conv5", "conv5_heavy", "conv6",
                                    "residual_unet"))
def test_expected_launches_count_the_passes_of_a_forward(monkeypatch, family):
    """chip_smoke.py's count of epilogue launches a forward, read from a
    shipped graph's parameters, is the number of passes with something to do
    in one bf16 enhance of that graph (on a card, one launch each)."""
    import chip_smoke as cs
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_any

    path = cs.family_artifact(family)
    enhance = enhance_from_onnx(path, device="cpu")
    passes = []

    def plain(y, b=None, **kw):
        if ce.mode_of(b, kw.get("pre", "identity"), kw.get("post", "identity"),
                      kw.get("residual"), kw.get("residual_bias")):
            passes.append(y.shape[-1])
        return ce.epilogue_plain(y, b, **kw)

    monkeypatch.setattr(conv_mod, "epilogue_plain", plain)
    frame = torch.randint(0, 256, (1, 48, 80, 4), generator=_gen(9), dtype=torch.uint8)
    enhance(frame.numpy())
    want = cs.epilogue_launches_expected(import_any(path).params)
    assert len(passes) == want > 0


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CHANNELS = (3, 36, 72, 108, 864)
# (1, 5, 7, C) leaves a ragged tail of elements past the last 16-byte vector
# at 3, 36 and 108 channels; (2, 64, 72, C) runs several vectors a thread
SHAPES = ((1, 5, 7), (2, 64, 72))


def _operands(shape, c, dtype, residual, device, seed=0):
    y = _rand((*shape, c), seed).to(device, dtype)
    b = _rand((c,), seed + 1, 0.5).to(device)
    r = _rand((*shape, c), seed + 2).to(device, dtype) if residual != "none" else None
    bp = _rand((c,), seed + 3, 0.5).to(device) if residual == "projection" else None
    return y, b, r, bp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp32"))
@pytest.mark.parametrize("c", CHANNELS)
def test_kernel_equals_plain(cuda, dtype, c):
    for shape, (pre, post, residual), bias in itertools.product(SHAPES, COMBOS, (True, False)):
        y, b, r, bp = _operands(shape, c, dtype, residual, cuda)
        b = b if bias else None
        if b is None and residual == "none" and pre == post == "identity":
            continue  # nothing to do: no launch
        keep = [t.clone() for t in (b, r, bp) if t is not None]
        want = ce.epilogue_plain(y.clone(), b, pre=pre, post=post, residual=r, residual_bias=bp)
        before = ce.conv_epilogue.launches
        got = ce.conv_epilogue(y, b, pre=pre, post=post, residual=r, residual_bias=bp)
        torch.cuda.synchronize()
        case = (shape, pre, post, residual, bias)
        assert got is y and ce.conv_epilogue.launches == before + 1, case
        assert torch.equal(got, want), case
        # its inputs other than y are left alone
        assert all(torch.equal(a, k) for a, k in zip((t for t in (b, r, bp) if t is not None),
                                                     keep)), case


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp32"))
@pytest.mark.parametrize("c", (3, 36, 108))
def test_kernel_takes_the_nchw_layout(cuda, dtype, c):
    """An output in NCHW memory (cuDNN's for an input whose strides are no
    NHWC tensor's) and a residual laid out as it: the strided path, bit for
    bit."""
    for (pre, post, residual), shape in itertools.product(COMBOS, ((1, 5, 7), (2, 16, 24))):
        y, b, r, bp = _operands(shape, c, dtype, residual, cuda)
        y = y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        r = None if r is None else r.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not y.is_contiguous() and ce.channel_stride(y) == shape[1] * shape[2]
        want = ce.epilogue_plain(y.clone(), b, pre=pre, post=post, residual=r, residual_bias=bp)
        before = ce.conv_epilogue.launches
        got = ce.conv_epilogue(y, b, pre=pre, post=post, residual=r, residual_bias=bp)
        torch.cuda.synchronize()
        case = (shape, pre, post, residual)
        assert got is y and ce.conv_epilogue.launches == before + 1, case
        assert torch.equal(got, want), case


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp32"))
def test_kernel_keeps_nan_inf_and_signed_zero_as_plain(cuda, dtype):
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, -1.0, 1.0, 3e38])
    y = special.repeat(36 * 5)[:36 * 37].reshape(1, 37, 36).to(cuda, dtype)
    r = special.flip(0).repeat(36 * 5)[:36 * 37].reshape(1, 37, 36).to(cuda, dtype)
    b = _rand((36,), 4).to(cuda)
    for pre, post in itertools.product(ACTS, ACTS):
        want = ce.epilogue_plain(y.clone(), b, pre=pre, post=post, residual=r)
        got = ce.conv_epilogue(y.clone(), b, pre=pre, post=post, residual=r)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    y = torch.zeros(2, 4, 6, 36, device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(36, device=cuda)
    flat = torch.zeros(2 * 4 * 6 * 36 + 1, device=cuda, dtype=torch.bfloat16)
    bad = [
        (dict(y=y.half()), "bf16 or fp32"),
        (dict(y=y.double()), "bf16 or fp32"),
        (dict(y=y[:, :, ::2]), "dense"),
        (dict(y=flat[1:].view(2, 4, 6, 36)), "aligned"),
        (dict(b=b.bfloat16()), "fp32"),
        (dict(b=torch.zeros(35, device=cuda)), "fp32"),
        (dict(b=torch.zeros(36)), "fp32"),
        (dict(b=torch.zeros(72, device=cuda)[::2]), "fp32"),
        (dict(residual=torch.zeros(2, 4, 6, 35, device=cuda, dtype=torch.bfloat16)), "residual"),
        (dict(residual=torch.zeros_like(y).float()), "residual"),
        (dict(residual=torch.zeros_like(y).transpose(1, 2).contiguous().transpose(1, 2)),
         "residual"),
        (dict(residual=y), "overlap"),
        (dict(residual=torch.zeros_like(y), residual_bias=b[:35]), "fp32"),
    ]
    for kw, msg in bad:
        args = dict(y=y, b=b)
        args.update(kw)
        before = ce.conv_epilogue.launches
        with pytest.raises(ValueError, match=msg):
            ce.conv_epilogue(args.pop("y"), args.pop("b"), **args)
        assert ce.conv_epilogue.launches == before
    cpu = torch.zeros(2, 4, 6, 36, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="residual"):
        ce.conv_epilogue(y, b, residual=cpu)


@pytest.mark.gpu
def test_conv2d_dispatch_on_a_card(cuda):
    """The kernel runs where autograd records nothing and raises on operands
    it does not take (fp16); grad-recording calls take the plain version.
    A slot of another activation splits the pass around it, same bits."""
    params = {k: v.to(cuda) for k, v in init_conv(36, 36, 3, generator=_gen(1)).items()}
    x = _rand((2, 8, 10, 36), 2).to(cuda, torch.bfloat16)
    before = ce.conv_epilogue.launches
    with torch.no_grad():
        a = conv2d(params, x, pre=_slots("relu"), residual=x)
    b = conv2d(params, x, pre=_slots("relu"), residual=x)  # grad on, nothing requires grad
    assert ce.conv_epilogue.launches == before + 2 and torch.equal(a, b)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        conv2d(params, x.half(), pre=_slots("relu"))
    assert ce.conv_epilogue.launches == before + 2
    with torch.no_grad():
        got = conv2d(params, x, pre=_slots("mish", "relu"), residual=x, post=_slots("silu"))
    assert ce.conv_epilogue.launches == before + 4  # the bias, then the residual
    want = conv2d(params, x.requires_grad_(True), pre=_slots("mish", "relu"), residual=x,
                  post=_slots("silu"))
    assert ce.conv_epilogue.launches == before + 4 and torch.equal(got, want.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "fp32"))
def test_conv2d_takes_an_nchw_output(cuda, dtype):
    """A frame given its batch axis by numpy's ``[None]`` (stride 0, as the
    int8 study's calibration frames) has no NHWC tensor's strides, and cuDNN
    writes NCHW for it: the kernel takes that layout, bit for bit with the
    plain chain."""
    params = {k: v.to(cuda) for k, v in init_conv(3, 36, 3, generator=_gen(1)).items()}
    frame = _rand((32, 48, 3), 2).numpy()[None]
    x = torch.as_tensor(frame, device=cuda).to(dtype)
    w = params["w"].to(dtype).permute(3, 2, 0, 1)
    bare = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    before = ce.conv_epilogue.launches
    with torch.no_grad():
        got = conv2d(params, x, pre=_slots("relu"), residual=bare.clone())
    assert ce.conv_epilogue.launches == before + 1
    assert not bare.is_contiguous() and ce.channel_stride(bare) == 32 * 48
    want = conv2d(params, x.requires_grad_(True), pre=_slots("relu"), residual=bare.clone())
    assert ce.conv_epilogue.launches == before + 1 and torch.equal(got, want.detach())


HEAVY_FRAME = (576, 736)
HEAVY_EPILOGUES = 98  # stem 1, conv1 32, conv2 32, conv3 32 (4 projections folded), dec_final 1


@pytest.mark.gpu
def test_heavyweight_unet_forward_equals_eager_chain(cuda):
    cfg = residual_unet.heavyweight_config()
    p = residual_unet.init(cfg, _gen(7), device=cuda)
    x = torch.rand((2, *HEAVY_FRAME, 3), generator=_gen(8)).to(cuda, torch.bfloat16)
    with torch.no_grad():
        before = ce.conv_epilogue.launches
        got = residual_unet.apply(p, x, cfg)
        torch.cuda.synchronize()
        launched = ce.conv_epilogue.launches - before
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            residual_unet.apply(p, x, cfg)
    assert launched == HEAVY_EPILOGUES
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::add", "aten::add_", "aten::relu", "aten::clamp_min"}, ops
    # the eager chain: the same forward with grad recorded, which takes the plain version
    leaves = []

    def walk(node):
        for v in node.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(p)
    for t in leaves:
        t.requires_grad_(True)
    before = ce.conv_epilogue.launches
    want = residual_unet.apply(p, x, cfg)
    torch.cuda.synchronize()
    assert ce.conv_epilogue.launches == before  # grad recorded: no launch
    assert want.requires_grad and torch.equal(got, want.detach())
