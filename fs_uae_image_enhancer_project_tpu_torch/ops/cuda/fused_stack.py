"""K1: the lightweight pix_shuffle conv stack as one CUDA kernel.

Counterpart of ``fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py``
(``_stack_kernel`` via ``_run_stack``, entry ``fused_stack_apply``). The
kernel (``csrc/fused_stack.cu``) maps unshuffled half-resolution frames
``(H/2, W/2, 12)`` or ``(N, H/2, W/2, 12)`` bf16 to the same shape through
all seven convs, accumulating in fp32; one launch takes the whole batch. The
wrapper does the rest in torch: unshuffle, bf16 cast, shuffle, ``+identity``
and relu.

- :func:`fused_stack` is the kernel's wrapper. A CUDA tensor launches the
  kernel (or raises); a CPU tensor takes :func:`fused_stack_plain`. Its
  launches are counted in ``fused_stack.launches``, with those of K1's
  enhance entry (``fused_enhance.py``: uint8 RGBA frames in and out, one
  launch a pix_shuffle enhance call), which ``fused_stack.u8_launches``
  also counts.
- ``torch.ops.fse.fused_stack`` is the same kernel as a registered custom op
  over tensors only (``u``, the seven fragment tensors, ``prm``), the form
  ``torch.export`` keeps in an exported program (``export/stablehlo.py``):
  its fake implementation gives the shape, its CUDA implementation checks
  the input, launches the kernel and counts the launch (when the program
  runs, not when it is traced), and its CPU implementation is the plain
  version, on weights read back from the fragments. It has no autograd
  formula: K1 has no backward. :func:`fused_stack` takes the op while
  ``torch.export`` or ``torch.compile`` traces it, and calls the kernel
  directly otherwise.
- :func:`fused_stack_plain` is the same function in eager torch: convs via
  ``F.conv2d`` in fp32 on the same bf16-rounded input and weights, fp32
  activations, each layer's output rounded to bf16 where the kernel stores it
  in shared memory, and the result cast to bf16 at the end. It uses the exact
  transcendentals where the kernel uses the hardware's approximate ones, so
  the two agree to within a few bf16 roundings (max 2.6e-3 with the shipped
  weights on an H100, against a 6e-3 limit).
- :func:`prepare_weights` is the counterpart of ``_prep_weights``: it lays the
  conv weights out in mma.sync B-fragment order and packs biases and
  activation parameters into one fp32 vector.
- :func:`stack_plain`, :func:`check_input`, :func:`launch_stack`,
  :func:`apply_stack` and :func:`cached` are shared with K2
  (``fused_stack_packed.py``), which differs only in the GEMM's form.

Unlike the JAX entry point there is no ``fallback``: a config other than the
lightweight one, or a shape the kernel does not take, raises ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..pixel_shuffle import pixel_shuffle, pixel_unshuffle

Params = Dict[str, dict]

# (conv name, [(cin, cin_pad) per source], cout, cout_pad); cin_pad/cout_pad
# are multiples of 8, the kernel's chunk of K and its mma tile width in N
LAYERS = (
    ("conv1", ((12, 16),), 36, 40),
    ("conv2", ((36, 40),), 36, 40),
    ("conv3", ((36, 40),), 72, 72),
    ("conv4", ((72, 72),), 72, 72),
    ("conv5", ((72, 72),), 36, 40),
    ("conv6", ((36, 40), (36, 40)), 36, 40),  # concat(l1, l5)
    ("conv7", ((36, 40),), 12, 16),
)

# the packed fp32 parameter vector: (name, length); offsets as P_* in the .cu
PARAM_LAYOUT = (
    ("b1", 40), ("b2", 40), ("b3", 72), ("b4", 72), ("b5", 40), ("b6", 40),
    ("b7", 16), ("p2b", 40), ("p2s", 40), ("p4b", 72), ("p4s", 72),
    ("scalars", 8),  # a1a a1b a2a a2b p7b p7s 0 0
)
PARAM_OFFSETS = {}
_o = 0
for _name, _n in PARAM_LAYOUT:
    PARAM_OFFSETS[_name] = (_o, _n)
    _o += _n
PARAM_TOTAL = _o  # 552

# multiply-adds per half-resolution pixel over the 7 convs
MACS_PER_PIXEL = 9 * (12 * 36 + 36 * 36 + 36 * 72 + 72 * 72 + 72 * 36 + 72 * 36 + 36 * 12)


class StackWeights(NamedTuple):
    """Prepared weights: B-fragment bf16 arrays for the kernel, the plain
    version's bf16-rounded fp32 weights (OIHW for K1, the pair-packed
    matrices of each source for K2), and the packed fp32 vector."""

    frags: Tuple[torch.Tensor, ...]
    plain: Tuple[torch.Tensor, ...]
    prm: torch.Tensor


def supports_config(cfg) -> bool:
    """True iff ``cfg`` is exactly the lightweight production topology (the
    kernel hard-codes its activation chain)."""
    from ...models.pix_shuffle import lightweight_config

    return cfg == lightweight_config()


def fragments(k: torch.Tensor) -> torch.Tensor:
    """A (K, N) fp32 GEMM weight, N a multiple of 8 -> flat bf16
    [kstep][ntile][lane][4], the mma.sync m16n8k16 B-fragment order (K padded
    with zero rows to a multiple of 16)."""
    if k.shape[0] % 16:
        k = F.pad(k, (0, 0, 0, 16 - k.shape[0] % 16))
    ks, nt = k.shape[0] // 16, k.shape[1] // 8
    # k = s*16 + khalf*8 + t*2 + pair, n = ntile*8 + g; lane = g*4 + t holds
    # (k 2t, 2t+1, 2t+8, 2t+9) of column g: the m16n8k16 B fragment
    f = k.reshape(ks, 2, 4, 2, nt, 8).permute(0, 4, 5, 2, 1, 3)
    return f.contiguous().to(torch.bfloat16).reshape(-1)


def _fragments(w: torch.Tensor, sources, cout: int, cout_pad: int) -> torch.Tensor:
    """(3, 3, cin, cout) fp32 HWIO -> K1's B fragments, k = (dy*3+dx)*cin_pad + c
    per source, the sources' rows one after the other."""
    rows, c0 = [], 0
    for cin, cin_pad in sources:
        ws = F.pad(w[:, :, c0:c0 + cin, :], (0, cout_pad - cout, 0, cin_pad - cin))
        rows.append(ws.reshape(9 * cin_pad, cout_pad))
        c0 += cin
    return fragments(torch.cat(rows))


def conv_weights(params: Params):
    """The seven conv weights as fp32 HWIO tensors on the CPU, shapes checked."""
    out = []
    for name, sources, cout, _ in LAYERS:
        w = torch.as_tensor(params[name]["w"]).detach().to("cpu", torch.float32)
        if tuple(w.shape) != (3, 3, sum(c for c, _ in sources), cout):
            raise ValueError(f"{name} weight has shape {tuple(w.shape)}")
        out.append(w)
    return out


def param_vector(params: Params) -> torch.Tensor:
    """Biases and activation parameters packed into the fp32 vector the
    kernels read (``PARAM_LAYOUT``), on the CPU."""

    def t(slot, leaf):
        return torch.as_tensor(params[slot][leaf]).detach().to("cpu", torch.float32)

    def vec(slot, leaf, n):
        v = t(slot, leaf).reshape(-1)
        return v.expand(n) if v.numel() == 1 else v

    parts = {f"b{i + 1}": t(name, "b") for i, (name, *_r) in enumerate(LAYERS)}
    parts.update(
        p2b=vec("l2_act4", "bias", 36), p2s=vec("l2_act4", "slope", 36),
        p4b=vec("l4_act2", "bias", 72), p4s=vec("l4_act2", "slope", 72),
        scalars=torch.stack([t("l1_act1", "a").reshape(()), t("l1_act1", "b").reshape(()),
                             t("l2_act3", "a").reshape(()), t("l2_act3", "b").reshape(()),
                             t("l7_act2", "bias").reshape(()),
                             t("l7_act2", "slope").reshape(())]),
    )
    prm = torch.cat([F.pad(parts[name], (0, n - parts[name].numel()))
                     for name, n in PARAM_LAYOUT])
    assert prm.numel() == PARAM_TOTAL
    return prm


def prepare_weights(params: Params, device) -> StackWeights:
    """Lay out the lightweight model's parameters for the kernel and its plain
    version, on ``device``."""

    frags, plain = [], []
    for (_name, sources, cout, cout_pad), w in zip(LAYERS, conv_weights(params)):
        frags.append(_fragments(w, sources, cout, cout_pad))
        plain.append(w.to(torch.bfloat16).float().permute(3, 2, 0, 1).contiguous())
    return StackWeights(
        tuple(f.to(device) for f in frags),
        tuple(w.to(device) for w in plain),
        param_vector(params).to(device),
    )


def cached(prepare):
    """``prepare(params, device)`` cached for the last parameter set. Keyed on
    the identity and version counter of every leaf, so replacing a leaf or
    updating one in place both invalidate the entry."""
    cache: dict = {}

    def prepare_cached(params: Params, device):
        leaves = []

        def walk(node):
            for k in sorted(node):
                v = node[k]
                walk(v) if isinstance(v, dict) else leaves.append(v)

        walk(params)
        key = (str(torch.device(device)),) + tuple(
            (id(v), getattr(v, "_version", 0)) for v in leaves)
        hit = cache.get(key)
        if hit is None:
            cache.clear()
            # keep the leaves alive so that their ids cannot be reused
            hit = (leaves, prepare(params, device))
            cache[key] = hit
        return hit[1]

    return prepare_cached


prepare_weights_cached = cached(prepare_weights)


def _prm(prm: torch.Tensor, name: str) -> torch.Tensor:
    o, n = PARAM_OFFSETS[name]
    return prm[o:o + n]


def stack_plain(u: torch.Tensor, prm: torch.Tensor, conv, *, out_fp32: bool = False) -> torch.Tensor:
    """The stack's function in eager torch around ``conv(i, *sources)``, which
    returns conv ``i`` (0-6) over the channel concat of its NCHW fp32 sources,
    bias added. Shared by K1's and K2's plain versions, which differ only in
    how they form the conv: fp32 activations, each layer's output rounded to
    bf16 where the kernels store it in shared memory.

    u: (H2, W2, 12) or (N, H2, W2, 12) bf16. Returns the same shape in bf16,
    or the fp32 result before the output cast with ``out_fp32=True``.
    """
    sc = _prm(prm, "scalars")
    a1a, a1b, a2a, a2b, p7b, p7s = (sc[i] for i in range(6))

    def ch(name, n):  # per-channel vector broadcast over NCHW
        return _prm(prm, name)[:n].view(1, n, 1, 1)

    def rb(x):  # where the kernel stores a layer's output in shared memory
        return x.to(torch.bfloat16).float()

    def sinlu(x, a, b):
        return torch.sigmoid(x) * (x + a * torch.sin(b * x))

    def bprelu(x, bias, slope):
        s = x - bias
        return torch.where(s >= 0, s, slope * s)

    def relu6(x):
        return x.clamp(0.0, 6.0)

    def mish(x):
        return x * torch.tanh(F.softplus(x))

    x = (u[None] if u.dim() == 3 else u).float().permute(0, 3, 1, 2)
    l1 = rb(relu6(sinlu(conv(0, x), a1a, a1b)))
    t = conv(1, l1)
    t = t * torch.tanh(torch.exp(t)) + l1
    l2 = rb(bprelu(sinlu(t, a2a, a2b), ch("p2b", 36), ch("p2s", 36)))
    l3 = rb(conv(2, l2))
    t = bprelu(mish(conv(3, l3)), ch("p4b", 72), ch("p4s", 72)) + l3
    l4 = rb(torch.relu(torch.tanh(t)))
    l5 = rb(conv(4, l4))
    l6 = rb(relu6(mish(conv(5, l1, l5))))
    y = bprelu(conv(6, l6), p7b, p7s).permute(0, 2, 3, 1).contiguous()
    y = y[0] if u.dim() == 3 else y
    return y if out_fp32 else y.to(torch.bfloat16)


def fused_stack_plain(u: torch.Tensor, sw: StackWeights, *, out_fp32: bool = False) -> torch.Tensor:
    """K1's function in eager torch, on any device: :func:`stack_plain` with
    ``F.conv2d`` in fp32 on the bf16-rounded weights. On a card, set
    ``torch.backends.cudnn.allow_tf32 = False`` for a full-fp32 reference.
    """
    def conv(i, *srcs):
        cout = sw.plain[i].shape[0]
        return F.conv2d(torch.cat(srcs, dim=1), sw.plain[i], _prm(sw.prm, f"b{i + 1}")[:cout],
                        padding=1)

    return stack_plain(u, sw.prm, conv, out_fp32=out_fp32)


def check_input(u: torch.Tensor, sw: StackWeights, name: str = "fused_stack") -> None:
    """Raise ``ValueError`` for an input the stack kernels do not take."""
    if u.dtype != torch.bfloat16 or u.dim() not in (3, 4) or u.shape[-1] != 12:
        raise ValueError(f"{name} takes (H2, W2, 12) or (N, H2, W2, 12) bf16, "
                         f"got {u.dtype} {tuple(u.shape)}")
    if not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous, 16-byte aligned input")
    if min(u.shape[:-1]) < 1 or (u.dim() == 4 and u.shape[0] > 65535):
        raise ValueError(f"{name} got an empty frame or too many frames {tuple(u.shape)}")
    for t in (*sw.frags, sw.prm):
        if t.device != u.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("prepared weights must be contiguous, 16-byte aligned (the "
                             "kernels stage them in 16-byte copies) and on the input's device")


def launch_stack(entry: str, u: torch.Tensor, sw: StackWeights, lib=None) -> torch.Tensor:
    """Launch the C entry point ``entry`` (K1 or K2) of ``lib`` (the
    package's kernel library by default) on ``u`` on the current stream;
    raises if the launch fails."""
    from .build import load_library

    lib = load_library() if lib is None else lib
    out = torch.empty_like(u)
    frames = 1 if u.dim() == 3 else u.shape[0]
    rc = getattr(lib, entry)(
        u.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in sw.frags), sw.prm.data_ptr(),
        frames, u.shape[-3], u.shape[-2], u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


INFO_KEYS = ("registers", "local_bytes", "static_smem", "dynamic_smem", "threads", "tile_rows",
             "tile_cols", "ring3_bytes")


def kernel_info(entry: str, device=0, lib=None) -> dict:
    """The compiled kernel's registers a thread, local memory a thread (its
    spills), shared memory, threads a CTA and plan (tile, ring bytes of
    layers 3-7), from ``<entry>_info`` (``cudaFuncGetAttributes``)."""
    import ctypes

    from .build import load_library

    lib = load_library() if lib is None else lib
    out = (ctypes.c_int * len(INFO_KEYS))()
    rc = getattr(lib, entry + "_info")(out, torch.device(device).index or 0)
    if rc != 0:
        raise RuntimeError(f"{entry}_info failed: CUDA error {rc}")
    return dict(zip(INFO_KEYS, out))


def _launch_k1(u: torch.Tensor, sw: StackWeights) -> torch.Tensor:
    check_input(u, sw, "fused_stack")
    out = launch_stack("fse_fused_stack", u, sw)
    fused_stack.launches += 1
    return out


def fused_stack(u: torch.Tensor, sw: StackWeights) -> torch.Tensor:
    """K1's wrapper: (H2, W2, 12) or (N, H2, W2, 12) bf16 -> the same shape.

    A CUDA tensor launches the kernel on the current stream (no synchronise,
    no allocation inside the kernel; one launch for the whole batch); a CPU
    tensor takes the plain version. Under ``torch.export`` (or
    ``torch.compile``) it records the custom op ``torch.ops.fse.fused_stack``
    instead, which does the same when the traced program runs.
    """
    if torch.compiler.is_compiling():
        return torch.ops.fse.fused_stack(u, *sw.frags, sw.prm)
    if u.device.type == "cpu":
        return fused_stack_plain(u, sw)
    if u.device.type != "cuda":
        raise ValueError(f"fused_stack runs on cuda or cpu, got {u.device}")
    return _launch_k1(u, sw)


fused_stack.launches = 0
fused_stack.u8_launches = 0


def plain_from_fragments(frags) -> Tuple[torch.Tensor, ...]:
    """The plain version's OIHW fp32 weights read back from K1's B fragments
    (the inverse of :func:`fragments` and of the per-source row layout): the
    bf16-rounded weights :func:`prepare_weights` gives, bit for bit."""
    out = []
    for (_name, sources, cout, cout_pad), f in zip(LAYERS, frags):
        rows = sum(9 * cin_pad for _c, cin_pad in sources)
        ks, nt = -(-rows // 16), cout_pad // 8
        k = f.float().reshape(ks, nt, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2).reshape(
            ks * 16, cout_pad)
        parts, r0 = [], 0
        for cin, cin_pad in sources:
            taps = k[r0:r0 + 9 * cin_pad].reshape(3, 3, cin_pad, cout_pad)
            parts.append(taps[:, :, :cin, :cout])
            r0 += 9 * cin_pad
        out.append(torch.cat(parts, dim=2).permute(3, 2, 0, 1).contiguous())
    return tuple(out)


@torch.library.custom_op("fse::fused_stack", mutates_args=(), device_types="cuda")
def fused_stack_op(u: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, f3: torch.Tensor,
                   f4: torch.Tensor, f5: torch.Tensor, f6: torch.Tensor, f7: torch.Tensor,
                   prm: torch.Tensor) -> torch.Tensor:
    """K1 as a custom op: launches the kernel (or raises) and counts it. An
    exported graph may hand it a strided view where the trace saw a
    contiguous tensor (``torch.export`` drops a ``contiguous()`` it judges a
    no-op), so the input is made contiguous here; outside a trace it already
    is, and nothing is copied."""
    return _launch_k1(u.contiguous(), StackWeights((f1, f2, f3, f4, f5, f6, f7), (), prm))


@fused_stack_op.register_kernel("cpu")
def _fused_stack_op_cpu(u, f1, f2, f3, f4, f5, f6, f7, prm):
    frags = (f1, f2, f3, f4, f5, f6, f7)
    return fused_stack_plain(u, StackWeights(frags, plain_from_fragments(frags), prm))


@fused_stack_op.register_fake
def _fused_stack_op_fake(u, f1, f2, f3, f4, f5, f6, f7, prm):
    return torch.empty_like(u)


def check_model_input(x: torch.Tensor, cfg) -> None:
    if not supports_config(cfg):
        raise ValueError("the fused stack takes the lightweight pix_shuffle config only")
    if x.dim() != 4 or x.shape[0] < 1 or x.shape[3] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            f"the fused stack takes (N, H, W, 3) with H and W even, got {tuple(x.shape)}")


def apply_stack(stack, prepare, params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The model's forward with ``stack(u, prepare(params, device))`` between
    pixel-unshuffle and pixel-shuffle: (N, H, W, 3) -> (N, H, W, 3)."""
    from ...models.pix_shuffle import lightweight_config

    cfg = lightweight_config() if cfg is None else cfg
    check_model_input(x, cfg)
    sw = prepare(params, x.device)
    u = pixel_unshuffle(x, 2).to(torch.bfloat16).contiguous()
    y = pixel_shuffle(stack(u, sw).to(x.dtype), 2)
    return torch.relu(x + y)


def fused_stack_apply(params: Params, x: torch.Tensor, *, cfg=None) -> torch.Tensor:
    """Drop-in for ``models.pix_shuffle.apply`` (lightweight config):
    (N, H, W, 3) linear float -> (N, H, W, 3), with bf16 compute through the
    kernel on a CUDA tensor and through its plain version on a CPU tensor."""
    return apply_stack(fused_stack, prepare_weights_cached, params, x, cfg)


def fused_stack_apply_plain(params: Params, x: torch.Tensor, *, cfg=None) -> torch.Tensor:
    """:func:`fused_stack_apply` with the plain version on any device: the
    reference the kernel is held against on the card."""
    return apply_stack(fused_stack_plain, prepare_weights_cached, params, x, cfg)
