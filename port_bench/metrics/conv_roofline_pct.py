"""conv6's share of its roofline: its operations on a frame at the bf16
peak over the device time a frame of all the enhance's kernels (copies
aside), from the trace."""
from port_bench.harness import peaks


def read(ctx):
    t, cfg = ctx.get("trace"), ctx["config"]
    if not ctx["cuda"] or not t or not t["frames"]:
        return None
    seconds = sum(v[0] for v in t["kernels"].values())
    if seconds <= 0:
        return None
    least = max(cfg["flop_per_frame"] / peaks.BF16_FLOP_PER_S,
                cfg["bytes_per_frame"] / peaks.HBM_BYTES_PER_S)
    return 100.0 * least * t["frames"] / seconds
