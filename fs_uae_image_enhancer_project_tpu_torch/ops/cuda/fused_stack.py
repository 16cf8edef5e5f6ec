"""K1: the lightweight pix_shuffle conv stack as one CUDA kernel.

Counterpart of ``fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py``
(``_stack_kernel`` via ``_run_stack``, entry ``fused_stack_apply``). The
kernel (``csrc/fused_stack.cu``) maps the unshuffled half-resolution frame
``(H/2, W/2, 12)`` bf16 to ``(H/2, W/2, 12)`` bf16 through all seven convs,
accumulating in fp32. The wrapper does the rest in torch: unshuffle, bf16
cast, shuffle, ``+identity`` and relu.

- :func:`fused_stack` is the kernel's wrapper. A CUDA tensor launches the
  kernel (or raises); a CPU tensor takes :func:`fused_stack_plain`. Its
  launches are counted in ``fused_stack.launches``.
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
    """Prepared weights: B-fragment bf16 arrays for the kernel, bf16-rounded
    fp32 OIHW weights for the plain version, and the packed fp32 vector."""

    frags: Tuple[torch.Tensor, ...]
    plain: Tuple[torch.Tensor, ...]
    prm: torch.Tensor


def supports_config(cfg) -> bool:
    """True iff ``cfg`` is exactly the lightweight production topology (the
    kernel hard-codes its activation chain)."""
    from ...models.pix_shuffle import lightweight_config

    return cfg == lightweight_config()


def _fragments(w: torch.Tensor, sources, cout: int, cout_pad: int) -> torch.Tensor:
    """(3, 3, cin, cout) fp32 HWIO -> flat bf16 [kstep][ntile][lane][4]."""
    rows, c0 = [], 0
    for cin, cin_pad in sources:
        ws = F.pad(w[:, :, c0:c0 + cin, :], (0, cout_pad - cout, 0, cin_pad - cin))
        rows.append(ws.reshape(9 * cin_pad, cout_pad))  # k = (dy*3+dx)*cin_pad + c
        c0 += cin
    k = torch.cat(rows)
    if k.shape[0] % 16:
        k = F.pad(k, (0, 0, 0, 16 - k.shape[0] % 16))
    ks, nt = k.shape[0] // 16, cout_pad // 8
    # k = s*16 + khalf*8 + t*2 + pair, n = ntile*8 + g; lane = g*4 + t holds
    # (k 2t, 2t+1, 2t+8, 2t+9) of column g: the m16n8k16 B fragment
    f = k.reshape(ks, 2, 4, 2, nt, 8).permute(0, 4, 5, 2, 1, 3)
    return f.contiguous().to(torch.bfloat16).reshape(-1)


def prepare_weights(params: Params, device) -> StackWeights:
    """Lay out the lightweight model's parameters for the kernel and its plain
    version, on ``device``."""

    def t(slot, leaf):
        return torch.as_tensor(params[slot][leaf]).detach().to("cpu", torch.float32)

    frags, plain = [], []
    for name, sources, cout, cout_pad in LAYERS:
        w = t(name, "w")
        if tuple(w.shape) != (3, 3, sum(c for c, _ in sources), cout):
            raise ValueError(f"{name} weight has shape {tuple(w.shape)}")
        frags.append(_fragments(w, sources, cout, cout_pad))
        plain.append(w.to(torch.bfloat16).float().permute(3, 2, 0, 1).contiguous())

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
    return StackWeights(
        tuple(f.to(device) for f in frags),
        tuple(w.to(device) for w in plain),
        prm.to(device),
    )


_PREP_CACHE: dict = {}


def prepare_weights_cached(params: Params, device) -> StackWeights:
    """:func:`prepare_weights`, cached for the last parameter set. Keyed on the
    identity and version counter of every leaf, so replacing a leaf or
    updating one in place both invalidate the entry."""
    leaves = []

    def walk(node):
        for k in sorted(node):
            v = node[k]
            walk(v) if isinstance(v, dict) else leaves.append(v)

    walk(params)
    key = (str(torch.device(device)),) + tuple(
        (id(v), getattr(v, "_version", 0)) for v in leaves)
    hit = _PREP_CACHE.get(key)
    if hit is None:
        _PREP_CACHE.clear()
        # keep the leaves alive so that their ids cannot be reused
        hit = (leaves, prepare_weights(params, device))
        _PREP_CACHE[key] = hit
    return hit[1]


def _prm(prm: torch.Tensor, name: str) -> torch.Tensor:
    o, n = PARAM_OFFSETS[name]
    return prm[o:o + n]


def fused_stack_plain(u: torch.Tensor, sw: StackWeights, *, out_fp32: bool = False) -> torch.Tensor:
    """The kernel's function in eager torch, on any device.

    u: (H2, W2, 12) bf16. Returns (H2, W2, 12) bf16, or the fp32 result before
    the output cast with ``out_fp32=True``. On a card, set
    ``torch.backends.cudnn.allow_tf32 = False`` for a full-fp32 reference.
    """
    p = sw.prm
    sc = _prm(p, "scalars")
    a1a, a1b, a2a, a2b, p7b, p7s = (sc[i] for i in range(6))

    def ch(name, n):  # per-channel vector broadcast over NCHW
        return _prm(p, name)[:n].view(1, n, 1, 1)

    def conv(x, i, cout):
        return F.conv2d(x, sw.plain[i], _prm(p, f"b{i + 1}")[:cout], padding=1)

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

    x = u.float().permute(2, 0, 1)[None]
    l1 = rb(relu6(sinlu(conv(x, 0, 36), a1a, a1b)))
    t = conv(l1, 1, 36)
    t = t * torch.tanh(torch.exp(t)) + l1
    l2 = rb(bprelu(sinlu(t, a2a, a2b), ch("p2b", 36), ch("p2s", 36)))
    l3 = rb(conv(l2, 2, 72))
    t = bprelu(mish(conv(l3, 3, 72)), ch("p4b", 72), ch("p4s", 72)) + l3
    l4 = rb(torch.relu(torch.tanh(t)))
    l5 = rb(conv(l4, 4, 36))
    l6 = rb(relu6(mish(conv(torch.cat([l1, l5], dim=1), 5, 36))))
    y = bprelu(conv(l6, 6, 12), p7b, p7s)[0].permute(1, 2, 0).contiguous()
    return y if out_fp32 else y.to(torch.bfloat16)


def _check(u: torch.Tensor, sw: StackWeights) -> None:
    if u.dtype != torch.bfloat16 or u.dim() != 3 or u.shape[2] != 12:
        raise ValueError(f"fused_stack takes (H2, W2, 12) bf16, got {u.dtype} {tuple(u.shape)}")
    if not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError("fused_stack takes a contiguous, 16-byte aligned input")
    if u.shape[0] < 1 or u.shape[1] < 1:
        raise ValueError(f"fused_stack got an empty frame {tuple(u.shape)}")
    for t in (*sw.frags, sw.prm):
        if t.device != u.device or not t.is_contiguous():
            raise ValueError("prepared weights must be contiguous and on the input's device")


def fused_stack(u: torch.Tensor, sw: StackWeights) -> torch.Tensor:
    """K1's wrapper: (H2, W2, 12) bf16 -> (H2, W2, 12) bf16.

    A CUDA tensor launches the kernel on the current stream (no synchronise,
    no allocation inside the kernel); a CPU tensor takes the plain version.
    """
    if u.device.type == "cpu":
        return fused_stack_plain(u, sw)
    if u.device.type != "cuda":
        raise ValueError(f"fused_stack runs on cuda or cpu, got {u.device}")
    _check(u, sw)
    from .build import load_library

    lib = load_library()
    out = torch.empty_like(u)
    rc = lib.fse_fused_stack(
        u.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in sw.frags), sw.prm.data_ptr(),
        u.shape[0], u.shape[1], u.device.index,
        torch.cuda.current_stream(u.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_stack kernel launch failed: CUDA error {rc}")
    fused_stack.launches += 1
    return out


fused_stack.launches = 0


def _check_model_input(x: torch.Tensor, cfg) -> None:
    if not supports_config(cfg):
        raise ValueError("the fused stack takes the lightweight pix_shuffle config only")
    if x.dim() != 4 or x.shape[0] != 1 or x.shape[3] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            f"the fused stack takes (1, H, W, 3) with H and W even, got {tuple(x.shape)}")


def _apply(stack, params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    from ...models.pix_shuffle import lightweight_config

    cfg = lightweight_config() if cfg is None else cfg
    _check_model_input(x, cfg)
    sw = prepare_weights_cached(params, x.device)
    u = pixel_unshuffle(x, 2)[0].to(torch.bfloat16).contiguous()
    y = pixel_shuffle(stack(u, sw)[None].to(x.dtype), 2)
    return torch.relu(x + y)


def fused_stack_apply(params: Params, x: torch.Tensor, *, cfg=None) -> torch.Tensor:
    """Drop-in for ``models.pix_shuffle.apply`` (lightweight config):
    (1, H, W, 3) linear float -> (1, H, W, 3), through the kernel on a CUDA
    tensor and through its plain version on a CPU tensor."""
    return _apply(fused_stack, params, x, cfg)


def fused_stack_apply_plain(params: Params, x: torch.Tensor, *, cfg=None) -> torch.Tensor:
    """:func:`fused_stack_apply` with the plain version on any device: the
    reference the kernel is held against on the card."""
    return _apply(fused_stack_plain, params, x, cfg)
