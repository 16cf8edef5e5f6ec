"""The residual U-Net's convolutions' share of their roofline: the
configuration's least time on a frame (its operations at the bf16 peak, or
its bytes at the HBM bandwidth, whichever is longer; operations bound it)
over the device time a frame of the convolution kernels that the
configuration's ``main_layer.kernels`` names match, from the trace."""
from port_bench.harness import peaks, trace


def read(ctx):
    t, cfg = ctx.get("trace"), ctx["config"]
    if not ctx["cuda"] or not t or not t["frames"]:
        return None
    seconds = trace.matching(t["kernels"], cfg["main_layer"]["kernels"])
    if seconds <= 0:
        return None
    least = max(cfg["flop_per_frame"] / peaks.BF16_FLOP_PER_S,
                cfg["bytes_per_frame"] / peaks.HBM_BYTES_PER_S)
    return 100.0 * least * t["frames"] / seconds
