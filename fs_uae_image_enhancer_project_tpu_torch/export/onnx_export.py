"""ONNX export: emit models as deployment-ready ONNX graphs.

The port's own copy of ``fs_uae_image_enhancer_project_tpu/export/onnx_export.py``,
plain numpy over the model configs. It writes the same bytes as the JAX
package's exporter for the same numpy parameters, so a model trained with the
port reaches the FS-UAE fork's ONNX Runtime integration unchanged. Callers
pass numpy parameter dicts: ``interop.params_to_numpy(params)``.

The emitted graph carries the whole chunky-RGBA deployment contract:
uint8 NHWC (1,576,752,4) input -> Transpose NCHW -> Slice alpha ->
[optional Slice crop-16] -> Cast -> Div 255 -> [Pow 2.2] -> model ->
[Pow 1/2.2] -> Mul 255 -> Clip -> Cast uint8 -> [Pad crop back] ->
Pad alpha=255 -> Transpose NHWC -> uint8 (1,576,752,4).

The model body is emitted op by op (convs in OIHW/NCHW, activations as
primitive ONNX chains: SinLU = Sigmoid/Sin/Mul/Add/Mul, BiasedPReLU =
Sub+PRelu, Mish = Softplus/Tanh/Mul, TeLU = Exp/Tanh/Mul, ReLU6 = Clip, ...)
with the protobuf writer of :mod:`onnx_proto`. PixelUnshuffle is the
Reshape/Transpose/Reshape sequence torch exports; PixelShuffle is
DepthToSpace mode=CRD.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import CROP_LEFT, FRAME_H, FRAME_W
from ..models.configs import PixShuffleConfig, act_config
from .onnx_proto import FLOAT, FLOAT16, UINT8, GraphBuilder

Params = Dict[str, dict]


def _np_dtype(elem_type: int):
    return np.float16 if elem_type == FLOAT16 else np.float32


class _ModelEmitter:
    """Emit model ops into a GraphBuilder (NCHW float domain)."""

    def __init__(self, b: GraphBuilder, params: Params, elem_type: int):
        self.b = b
        self.params = params
        self.elem = elem_type
        self.np_dtype = _np_dtype(elem_type)

    def const(self, name: str, arr: np.ndarray) -> str:
        return self.b.add_initializer(name, arr)

    def scalar(self, name: str, v: float) -> str:
        return self.const(name, np.array(v, self.np_dtype))

    def conv(self, name: str, x: str) -> str:
        p = self.params[name]
        w_hwio = np.asarray(p["w"], np.float32)
        kh, kw = w_hwio.shape[:2]  # per-axis: non-square kernels are legal
        w_oihw = np.transpose(w_hwio, (3, 2, 0, 1)).astype(self.np_dtype)
        self.const(f"{name}.weight", w_oihw)
        inputs = [x, f"{name}.weight"]
        if "b" in p:
            self.const(f"{name}.bias", np.asarray(p["b"], self.np_dtype))
            inputs.append(f"{name}.bias")
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        (y,) = self.b.add_node(
            "Conv", inputs, [f"{name}_out"],
            # ONNX pads order: [h_begin, w_begin, h_end, w_end]
            kernel_shape=[kh, kw], pads=[ph, pw, ph, pw],
            strides=[1, 1], group=1,
        )
        return y

    # -- activations -----------------------------------------------------------
    def activation(self, slot: str, spec, x: str) -> str:
        name, cfg = spec[0], dict(spec[1])
        b = self.b
        p = self.params.get(slot, {})

        def per_channel(vec: np.ndarray, tag: str) -> str:
            return self.const(
                f"{slot}.{tag}", vec.astype(self.np_dtype).reshape(-1, 1, 1)
            )

        if name == "identity":
            return x
        if name == "relu":
            return b.add_node("Relu", [x], [f"{slot}_out"])[0]
        if name == "relu6":
            lo = self.scalar(f"{slot}_min", 0.0)
            hi = self.scalar(f"{slot}_max", 6.0)
            return b.add_node("Clip", [x, lo, hi], [f"{slot}_out"])[0]
        if name == "sigmoid":
            return b.add_node("Sigmoid", [x], [f"{slot}_out"])[0]
        if name == "tanh":
            return b.add_node("Tanh", [x], [f"{slot}_out"])[0]
        if name in ("silu", "swish"):
            s = b.add_node("Sigmoid", [x])[0]
            return b.add_node("Mul", [x, s], [f"{slot}_out"])[0]
        if name == "mish":
            sp = b.add_node("Softplus", [x])[0]
            th = b.add_node("Tanh", [sp])[0]
            return b.add_node("Mul", [x, th], [f"{slot}_out"])[0]
        if name == "telu":
            e = b.add_node("Exp", [x])[0]
            th = b.add_node("Tanh", [e])[0]
            return b.add_node("Mul", [x, th], [f"{slot}_out"])[0]
        if name == "gelu":
            half = self.scalar(f"{slot}_half", 0.5)
            one = self.scalar(f"{slot}_one", 1.0)
            if str(cfg.get("approximate", "none")) == "tanh":
                # tanh approximation (torch GELU(approximate='tanh')):
                # 0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
                c0 = self.scalar(f"{slot}_c0", 0.7978845608028654)
                c1 = self.scalar(f"{slot}_c1", 0.044715)
                x2 = b.add_node("Mul", [x, x])[0]
                x3 = b.add_node("Mul", [x2, x])[0]
                inner = b.add_node("Add", [x, b.add_node("Mul", [x3, c1])[0]])[0]
                t = b.add_node("Tanh", [b.add_node("Mul", [inner, c0])[0]])[0]
                a = b.add_node("Add", [t, one])[0]
            else:
                # opset-13-valid erf decomposition (Gelu op needs opset >= 20):
                # 0.5 * x * (1 + erf(x / sqrt(2)))
                sq2 = self.scalar(f"{slot}_sqrt2", 1.4142135623730951)
                d = b.add_node("Div", [x, sq2])[0]
                e = b.add_node("Erf", [d])[0]
                a = b.add_node("Add", [e, one])[0]
            xm = b.add_node("Mul", [x, a])[0]
            return b.add_node("Mul", [xm, half], [f"{slot}_out"])[0]
        if name == "elu":
            return b.add_node(
                "Elu", [x], [f"{slot}_out"], alpha=float(cfg.get("alpha", 1.0))
            )[0]
        if name == "leaky_relu":
            return b.add_node(
                "LeakyRelu", [x], [f"{slot}_out"],
                alpha=float(cfg.get("negative_slope", 0.01)),
            )[0]
        if name == "softplus":
            return b.add_node("Softplus", [x], [f"{slot}_out"])[0]
        if name in ("softmax", "log_softmax"):
            # model acts are NHWC-axis configs; the graph is NCHW
            nhwc_axis = int(cfg.get("axis", -1))
            axis = {-1: 1, 3: 1, 0: 0, 1: 2, 2: 3}[nhwc_axis]
            op = "Softmax" if name == "softmax" else "LogSoftmax"
            return b.add_node(op, [x], [f"{slot}_out"], axis=axis)[0]
        if name == "scaled_tanh":
            th = b.add_node("Tanh", [x])[0]
            one = self.scalar(f"{slot}_one", 1.0)
            half = self.scalar(f"{slot}_half", 0.5)
            a = b.add_node("Add", [th, one])[0]
            return b.add_node("Mul", [a, half], [f"{slot}_out"])[0]
        if name == "sinlu":
            # sigmoid(x) * (x + a*sin(b*x))  (activations.py:22-32)
            a_c = self.const(f"{slot}.a", np.asarray(p["a"], self.np_dtype))
            b_c = self.const(f"{slot}.b", np.asarray(p["b"], self.np_dtype))
            sig = b.add_node("Sigmoid", [x])[0]
            bx = b.add_node("Mul", [b_c, x])[0]
            s = b.add_node("Sin", [bx])[0]
            asin = b.add_node("Mul", [a_c, s])[0]
            inner = b.add_node("Add", [x, asin])[0]
            return b.add_node("Mul", [sig, inner], [f"{slot}_out"])[0]
        if name == "prelu":
            slope = per_channel(np.asarray(p["slope"]), "slope")
            return b.add_node("PRelu", [x, slope], [f"{slot}_out"])[0]
        if name == "biased_relu":
            bias = per_channel(np.asarray(p["bias"]), "bias")
            sub = b.add_node("Sub", [x, bias])[0]
            return b.add_node("Relu", [sub], [f"{slot}_out"])[0]
        if name == "biased_prelu":
            bias = per_channel(np.asarray(p["bias"]), "bias")
            slope = per_channel(np.asarray(p["slope"]), "slope")
            sub = b.add_node("Sub", [x, bias])[0]
            return b.add_node("PRelu", [sub, slope], [f"{slot}_out"])[0]
        raise ValueError(f"ONNX emission for activation '{name}' not implemented")


def _emit_pix_shuffle_body(
    em: _ModelEmitter, cfg: PixShuffleConfig, x: str, n: int, h: int, w: int
) -> str:
    """The pix_shuffle forward (model body, NCHW float), mirroring
    models/pix_shuffle.py apply()."""
    b = em.b
    r = cfg.shuffle_factor
    identity = x
    # PixelUnshuffle(2) — shared emitter; tag 'unshuffle' keeps the exact
    # initializer names this body always used (byte-stable artifacts)
    t = _emit_pixel_unshuffle(em, x, "unshuffle", n, cfg.in_channels, h, w, r)

    t = _emit_conv7_chain(em, cfg.layers, t)
    # PixelShuffle(2) == DepthToSpace mode=CRD
    t = b.add_node("DepthToSpace", [t], blocksize=r, mode="CRD")[0]
    t = b.add_node("Add", [identity, t])[0]
    return b.add_node("Relu", [t], ["model_output"])[0]


def _emit_conv7_chain(em: _ModelEmitter, L, t: str) -> str:
    """The shared 7-conv chain (pix_shuffle body == conv6 body: residual
    adds at layers 2/4 with optional projections, long-skip concat into
    layer 6 — models/pix_shuffle.py apply / models/conv6.py apply)."""
    b = em.b

    def acts(layer_i: int, slots, t: str) -> str:
        for si in slots:
            spec = L[layer_i - 1].acts[si - 1]
            t = em.activation(f"l{layer_i}_act{si}", spec, t)
        return t

    t = em.conv("conv1", t)
    t = acts(1, (1, 2), t)
    long_skip = t
    short = t
    t = em.conv("conv2", t)
    t = acts(2, (1, 2), t)
    if "skip1_proj" in em.params:
        short = em.conv("skip1_proj", short)
    t = b.add_node("Add", [short, t])[0]
    t = acts(2, (3, 4), t)
    t = em.conv("conv3", t)
    t = acts(3, (1, 2), t)
    short = t
    t = em.conv("conv4", t)
    t = acts(4, (1, 2), t)
    if "skip2_proj" in em.params:
        short = em.conv("skip2_proj", short)
    t = b.add_node("Add", [short, t])[0]
    t = acts(4, (3, 4), t)
    t = em.conv("conv5", t)
    t = acts(5, (1, 2), t)
    t = b.add_node("Concat", [long_skip, t], axis=1)[0]
    t = em.conv("conv6", t)
    t = acts(6, (1, 2), t)
    t = em.conv("conv7", t)
    t = acts(7, (1, 2), t)
    return t


def _flatten_params(params: Params, prefix: str = "") -> Params:
    """Flatten nested block pytrees to dotted keys so the emitter's flat
    ``params[name]`` lookups (and initializer names) stay collision-free:
    ``{"enc0_block0": {"conv1": {...}}}`` -> ``{"enc0_block0.conv1": {...}}``.
    Leaves are the per-op dicts (anything containing an array-valued 'w',
    'slope', 'bias', 'a', ...)."""
    flat: Params = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) and v and all(
            isinstance(sv, dict) for sv in v.values()
        ):
            flat.update(_flatten_params(v, f"{name}."))
        else:
            flat[name] = v
    return flat


def _emit_pixel_unshuffle(
    em: _ModelEmitter, x: str, tag: str, n: int, c: int, h: int, w: int, r: int
) -> str:
    """torch PixelUnshuffle(r) as Reshape/Transpose/Reshape (the pattern
    torch itself exports; matches ops/pixel_shuffle.pixel_unshuffle)."""
    b = em.b
    s1 = em.const(f"{tag}_shape1",
                  np.array([n, c, h // r, r, w // r, r], np.int64))
    t = b.add_node("Reshape", [x, s1])[0]
    t = b.add_node("Transpose", [t], perm=[0, 1, 3, 5, 2, 4])[0]
    s2 = em.const(f"{tag}_shape2",
                  np.array([n, c * r * r, h // r, w // r], np.int64))
    return b.add_node("Reshape", [t, s2])[0]


def _emit_feature_block(em: _ModelEmitter, block: str, x: str,
                        acts_resolved) -> str:
    """ResidualFeatureBlock (models/blocks.apply_feature_block:94-107):
    conv1 -> conv2 -> act1 -> act2 -> conv3 -> act3 -> (+identity/proj) ->
    act4. ``acts_resolved`` comes from models.blocks.resolve_block_acts."""
    b = em.b
    identity = x
    t = em.conv(f"{block}.conv1", x)
    t = em.conv(f"{block}.conv2", t)
    t = em.activation(f"{block}.act1", acts_resolved[0], t)
    t = em.activation(f"{block}.act2", acts_resolved[1], t)
    t = em.conv(f"{block}.conv3", t)
    t = em.activation(f"{block}.act3", acts_resolved[2], t)
    if f"{block}.proj" in em.params:
        identity = em.conv(f"{block}.proj", identity)
    t = b.add_node("Add", [identity, t])[0]
    return em.activation(f"{block}.act4", acts_resolved[3], t)


def _emit_residual_unet_body(
    em: _ModelEmitter, cfg, x: str, n: int, h: int, w: int
) -> str:
    """The residual U-Net forward (models/residual_unet.apply:96-133) in
    NCHW: unshuffle stem, per-level encoder blocks, bottleneck, decoder
    with DepthToSpace(CRD) upsampling + skip concats (original input at the
    top level), final ReLU."""
    from ..models.blocks import resolve_block_acts
    from ..models.residual_unet import _level_channels, _mid

    b = em.b
    lc = _level_channels(cfg)
    original = x
    t = _emit_pixel_unshuffle(em, x, "stem_unshuffle", n,
                              cfg.input_channels, h, w, 2)
    t = em.conv("stem", t)
    ch, cur_h, cur_w = lc[0], h // 2, w // 2
    enc_feats = []
    for i in range(cfg.blocks_per_level):
        t = _emit_feature_block(
            em, f"enc0_block{i}", t,
            resolve_block_acts(cfg.acts, _mid(cfg, lc[0]), lc[0]))
    enc_feats.append(t)
    for d in range(1, cfg.unet_depth):
        t = _emit_pixel_unshuffle(em, t, f"enc{d}_unshuffle", n,
                                  ch, cur_h, cur_w, 2)
        ch, cur_h, cur_w = ch * 4, cur_h // 2, cur_w // 2
        for i in range(cfg.blocks_per_level):
            t = _emit_feature_block(
                em, f"enc{d}_block{i}", t,
                resolve_block_acts(cfg.acts, _mid(cfg, lc[d]), lc[d]))
        ch = lc[d]
        enc_feats.append(t)
    for i in range(cfg.blocks_per_level):
        t = _emit_feature_block(
            em, f"bottleneck_block{i}", t,
            resolve_block_acts(cfg.acts, _mid(cfg, lc[-1]), lc[-1]))
    for i in range(cfg.unet_depth):
        d_val = cfg.unet_depth - 1 - i
        t = b.add_node("DepthToSpace", [t], blocksize=2, mode="CRD")[0]
        skip = original if d_val == 0 else enc_feats[d_val - 1]
        t = b.add_node("Concat", [t, skip], axis=1)[0]
        if d_val == 0:
            t = em.conv("dec_final", t)
        else:
            out_ch = cfg.base_channels * (2 ** d_val)
            for j in range(cfg.blocks_per_level):
                t = _emit_feature_block(
                    em, f"dec{i}_block{j}", t,
                    resolve_block_acts(cfg.acts, _mid(cfg, out_ch), out_ch))
    return b.add_node("Relu", [t], ["model_output"])[0]


def export_conv6_onnx(
    params: Params,
    cfg,
    out_path: str,
    *,
    fp16: bool = False,
    frame_h: int = FRAME_H,
    frame_w: int = FRAME_W,
) -> str:
    """Emit a conv6 deployment artifact. conv6 is the reference's phantom
    NAS target (the module the optuna studies import but the repo never
    shipped — optuna_study_prune_act_r2.py:106-113); here the family is
    both trainable AND deployable: full-res 7-conv chain (shared with
    pix_shuffle's body), global identity residual + ReLU, linear-light
    gamma wrapper, full chunky-RGBA contract."""
    elem = FLOAT16 if fp16 else FLOAT
    b = GraphBuilder("fs_uae_enhance_conv6")
    em = _ModelEmitter(b, params, elem)
    n = 1
    b.add_input("input_rgba_chunky", UINT8, (n, frame_h, frame_w, 4))
    t = b.add_node("Transpose", ["input_rgba_chunky"], perm=[0, 3, 1, 2])[0]
    starts = b.add_initializer("slice_starts_constant", np.array([0], np.int64))
    ends = b.add_initializer("slice_ends_constant", np.array([3], np.int64))
    axes = b.add_initializer("slice_axes_constant", np.array([1], np.int64))
    t = b.add_node("Slice", [t, starts, ends, axes])[0]
    t = b.add_node("Cast", [t], to=elem)[0]
    c255 = em.scalar("div_by_255_constant", 255.0)
    t = b.add_node("Div", [t, c255])[0]
    g1 = em.scalar("gamma_srgb_to_linear_exponent", 2.2)
    t = b.add_node("Pow", [t, g1])[0]

    identity = t
    t = _emit_conv7_chain(em, cfg.layers, t)
    t = b.add_node("Add", [identity, t])[0]
    t = b.add_node("Relu", [t], ["model_output"])[0]

    g2 = em.scalar("gamma_linear_to_srgb_exponent", 1.0 / 2.2)
    t = b.add_node("Pow", [t, g2])[0]
    t = b.add_node("Mul", [t, c255])[0]
    zero = em.scalar("clip_min_constant", 0.0)
    t = b.add_node("Clip", [t, zero, c255])[0]
    t = b.add_node("Cast", [t], to=UINT8)[0]
    apads = b.add_initializer(
        "pad_pads_constant", np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int64))
    aval = b.add_initializer("pad_value_constant", np.array(255, np.uint8))
    t = b.add_node("Pad", [t, apads, aval])[0]
    b.add_node("Transpose", [t], ["output_rgba_uint8_chunky"],
               perm=[0, 2, 3, 1])
    b.add_output("output_rgba_uint8_chunky", UINT8, (n, frame_h, frame_w, 4))
    with open(out_path, "wb") as f:
        f.write(b.serialize_model(opset=13))
    return out_path


def export_residual_unet_onnx(
    params: Params,
    cfg,
    out_path: str,
    *,
    crop_left: int = CROP_LEFT,
    fp16: bool = False,
    frame_h: int = FRAME_H,
    frame_w: int = FRAME_W,
) -> str:
    """Emit a residual U-Net deployment artifact — a capability the
    reference does NOT have (convertion_tools/torch2onnx.py handles only
    the conv and pix_shuffle families; model_residual_unet.py ships with no
    artifacts). Same chunky-RGBA + gamma wrapper contract as pix_shuffle;
    crop_left=16 keeps the model width at 736, divisible by 2^depth for
    depth <= 4."""
    elem = FLOAT16 if fp16 else FLOAT
    model_w = frame_w - crop_left
    factor = 2 ** cfg.unet_depth
    if frame_h % factor or model_w % factor:
        raise ValueError(
            f"{frame_h}x{model_w} not divisible by 2^depth={factor}")
    b = GraphBuilder("fs_uae_enhance_unet")
    em = _ModelEmitter(b, _flatten_params(params), elem)
    n = 1

    b.add_input("input_rgba_chunky", UINT8, (n, frame_h, frame_w, 4))
    t = b.add_node("Transpose", ["input_rgba_chunky"], perm=[0, 3, 1, 2])[0]
    starts = b.add_initializer("slice_starts_constant", np.array([0], np.int64))
    ends = b.add_initializer("slice_ends_constant", np.array([3], np.int64))
    axes = b.add_initializer("slice_axes_constant", np.array([1], np.int64))
    t = b.add_node("Slice", [t, starts, ends, axes])[0]
    if crop_left:
        cs = b.add_initializer("crop_starts", np.array([crop_left], np.int64))
        ce = b.add_initializer("crop_ends", np.array([frame_w], np.int64))
        ca = b.add_initializer("crop_axes", np.array([3], np.int64))
        t = b.add_node("Slice", [t, cs, ce, ca])[0]
    t = b.add_node("Cast", [t], to=elem)[0]
    c255 = em.scalar("div_by_255_constant", 255.0)
    t = b.add_node("Div", [t, c255])[0]
    g1 = em.scalar("gamma_srgb_to_linear_exponent", 2.2)
    t = b.add_node("Pow", [t, g1])[0]

    out = _emit_residual_unet_body(em, cfg, t, n, frame_h, model_w)

    g2 = em.scalar("gamma_linear_to_srgb_exponent", 1.0 / 2.2)
    t = b.add_node("Pow", [out, g2])[0]
    t = b.add_node("Mul", [t, c255])[0]
    zero = em.scalar("clip_min_constant", 0.0)
    t = b.add_node("Clip", [t, zero, c255])[0]
    t = b.add_node("Cast", [t], to=UINT8)[0]
    if crop_left:
        pads = b.add_initializer(
            "crop_pad_pads",
            np.array([0, 0, 0, crop_left, 0, 0, 0, 0], np.int64))
        zero_u8 = b.add_initializer("crop_pad_value", np.array(0, np.uint8))
        t = b.add_node("Pad", [t, pads, zero_u8])[0]
    apads = b.add_initializer(
        "pad_pads_constant", np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int64))
    aval = b.add_initializer("pad_value_constant", np.array(255, np.uint8))
    t = b.add_node("Pad", [t, apads, aval])[0]
    b.add_node("Transpose", [t], ["output_rgba_uint8_chunky"],
               perm=[0, 2, 3, 1])
    b.add_output("output_rgba_uint8_chunky", UINT8, (n, frame_h, frame_w, 4))
    with open(out_path, "wb") as f:
        f.write(b.serialize_model(opset=13))
    return out_path


def export_conv_stack_onnx(
    params: Params,
    cfg,
    out_path: str,
    *,
    fp16: bool = True,
    frame_h: int = FRAME_H,
    frame_w: int = FRAME_W,
    relu_before_residual_add: bool = False,
) -> str:
    """Emit a conv3/conv5-family deployment artifact (fused params).

    sRGB-domain wrapper (no gamma pow — matching the reference's conv3/conv5
    graphs): uint8 RGBA chunky -> /255 -> conv stack -> x255 -> clip ->
    alpha pad -> uint8 RGBA chunky.

    ``relu_before_residual_add=False`` (default) keeps the *training*
    residual semantics (add before ReLU, model_conv5.py:128-144);
    ``True`` reproduces the reference's *deployed* graphs (Conv->Relu->Add,
    a torch fuse_modules artefact) — use it when re-exporting weights
    imported from a shipped artifact so behaviour matches bit-for-bit
    (mirrors models/conv_stack.apply_fused).
    """
    elem = FLOAT16 if fp16 else FLOAT
    b = GraphBuilder("fs_uae_enhance_conv")
    em = _ModelEmitter(b, params, elem)
    n = 1
    b.add_input("input_rgba_chunky", UINT8, (n, frame_h, frame_w, 4))
    t = b.add_node(
        "Transpose", ["input_rgba_chunky"], perm=[0, 3, 1, 2]
    )[0]
    starts = b.add_initializer("slice_starts_constant", np.array([0], np.int64))
    ends = b.add_initializer("slice_ends_constant", np.array([3], np.int64))
    axes = b.add_initializer("slice_axes_constant", np.array([1], np.int64))
    t = b.add_node("Slice", [t, starts, ends, axes])[0]
    t = b.add_node("Cast", [t], to=elem)[0]
    c255 = em.scalar("div_by_255_constant", 255.0)
    t = b.add_node("Div", [t, c255])[0]

    n_layers = len(cfg.channels)
    for i in range(n_layers):
        skip = t if i in cfg.residual_layers else None
        t = em.conv(f"conv{i + 1}", t)
        is_last = i == n_layers - 1
        if relu_before_residual_add:
            if not is_last:
                t = b.add_node("Relu", [t])[0]
            elif cfg.final_act == "sigmoid":
                t = b.add_node("Sigmoid", [t])[0]
            if skip is not None:
                t = b.add_node("Add", [skip, t])[0]
        else:
            if skip is not None:
                t = b.add_node("Add", [skip, t])[0]
            if not is_last:
                t = b.add_node("Relu", [t])[0]
            elif cfg.final_act == "sigmoid":
                t = b.add_node("Sigmoid", [t])[0]

    t = b.add_node("Mul", [t, c255])[0]
    zero = em.scalar("clip_min_constant", 0.0)
    t = b.add_node("Clip", [t, zero, c255])[0]
    t = b.add_node("Cast", [t], to=UINT8)[0]
    apads = b.add_initializer(
        "pad_pads_constant", np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int64)
    )
    aval = b.add_initializer("pad_value_constant", np.array(255, np.uint8))
    t = b.add_node("Pad", [t, apads, aval])[0]
    b.add_node("Transpose", [t], ["output_rgba_uint8_chunky"], perm=[0, 2, 3, 1])
    b.add_output("output_rgba_uint8_chunky", UINT8, (n, frame_h, frame_w, 4))
    with open(out_path, "wb") as f:
        f.write(b.serialize_model(opset=13))
    return out_path


def export_pix_shuffle_onnx(
    params: Params,
    cfg: PixShuffleConfig,
    out_path: str,
    *,
    crop_left: int = CROP_LEFT,
    fp16: bool = True,
    frame_h: int = FRAME_H,
    frame_w: int = FRAME_W,
    srgb_to_linear_exponent: float = 2.2,
    linear_to_srgb_exponent: float = 1.0 / 2.2,
) -> str:
    """Emit the full deployment artifact for a pix_shuffle model."""
    elem = FLOAT16 if fp16 else FLOAT
    b = GraphBuilder("fs_uae_enhance")
    em = _ModelEmitter(b, params, elem)
    n = 1
    model_w = frame_w - crop_left

    b.add_input("input_rgba_chunky", UINT8, (n, frame_h, frame_w, 4))
    t = b.add_node(
        "Transpose", ["input_rgba_chunky"],
        ["input_rgba_chunky_transposed_planar_uint8"], perm=[0, 3, 1, 2],
    )[0]
    # Slice RGB off the RGBA planar tensor (axis 1, 0:3)
    starts = b.add_initializer("slice_starts_constant", np.array([0], np.int64))
    ends = b.add_initializer("slice_ends_constant", np.array([3], np.int64))
    axes = b.add_initializer("slice_axes_constant", np.array([1], np.int64))
    t = b.add_node(
        "Slice", [t, starts, ends, axes], ["input_rgb_uint8_planar_sliced"]
    )[0]
    if crop_left:
        cs = b.add_initializer("crop_starts", np.array([crop_left], np.int64))
        ce = b.add_initializer("crop_ends", np.array([frame_w], np.int64))
        ca = b.add_initializer("crop_axes", np.array([3], np.int64))
        t = b.add_node("Slice", [t, cs, ce, ca], ["input_rgb_uint8_cropped"])[0]
    t = b.add_node("Cast", [t], ["input_rgb_float_planar"], to=elem)[0]
    c255 = em.scalar("div_by_255_constant", 255.0)
    t = b.add_node("Div", [t, c255], ["input_rgb_float_normalized"])[0]
    g1 = em.scalar("gamma_srgb_to_linear_exponent", srgb_to_linear_exponent)
    t = b.add_node("Pow", [t, g1], ["input_rgb_float_linear"])[0]

    out = _emit_pix_shuffle_body(em, cfg, t, n, frame_h, model_w)

    g2 = em.scalar("gamma_linear_to_srgb_exponent", linear_to_srgb_exponent)
    t = b.add_node("Pow", [out, g2], ["output_rgb_float_srgb"])[0]
    t = b.add_node("Mul", [t, c255], ["output_rgb_float_denormalized"])[0]
    zero = em.scalar("clip_min_constant", 0.0)
    t = b.add_node("Clip", [t, zero, c255], ["output_rgb_float_clipped"])[0]
    t = b.add_node("Cast", [t], ["output_rgb_uint8_planar"], to=UINT8)[0]
    if crop_left:
        pads = b.add_initializer(
            "crop_pad_pads", np.array([0, 0, 0, crop_left, 0, 0, 0, 0], np.int64)
        )
        zero_u8 = b.add_initializer("crop_pad_value", np.array(0, np.uint8))
        t = b.add_node("Pad", [t, pads, zero_u8], ["output_rgb_uint8_padded"])[0]
    # pad alpha=255 on the channel axis (torch2onnx.py:677-713)
    apads = b.add_initializer(
        "pad_pads_constant", np.array([0, 0, 0, 0, 0, 1, 0, 0], np.int64)
    )
    aval = b.add_initializer("pad_value_constant", np.array(255, np.uint8))
    t = b.add_node("Pad", [t, apads, aval], ["output_rgba_uint8_planar_padded"])[0]
    b.add_node(
        "Transpose", [t], ["output_rgba_uint8_chunky"], perm=[0, 2, 3, 1]
    )
    b.add_output("output_rgba_uint8_chunky", UINT8, (n, frame_h, frame_w, 4))

    data = b.serialize_model(opset=13)
    with open(out_path, "wb") as f:
        f.write(data)
    return out_path
