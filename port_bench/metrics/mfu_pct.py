"""The whole enhance step's share of the bf16 peak: the configuration's
operations a frame times the frames completed in the traced slice, over the
slice's seconds and the card's published 989 TFLOP/s."""
from port_bench.harness import peaks


def read(ctx):
    t = ctx.get("trace")
    if not ctx["cuda"] or not t or not t["frames"] or t["busy_s"] <= 0:
        return None
    flop = ctx["config"]["flop_per_frame"] * t["frames"]
    return 100.0 * flop / t["window_s"] / peaks.BF16_FLOP_PER_S
