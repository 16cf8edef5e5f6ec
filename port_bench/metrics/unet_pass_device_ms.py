"""Device ms a frame of the residual U-Net cell's kernels that are not its
convolutions (by the configuration's ``main_layer.kernels``): the bias and
residual adds, ReLUs and clamps, concats and shuffles, cuDNN's padding and
layout passes, the weights' casts, and the enhance's prologue and epilogue,
from the trace; copies are not kernels here."""
from port_bench.harness import trace


def read(ctx):
    t = ctx.get("trace")
    if not ctx["cuda"] or not t or not t["frames"]:
        return None
    kernels = t["kernels"]
    convs = trace.matching(kernels, ctx["config"]["main_layer"]["kernels"])
    if convs <= 0:
        return None
    return 1e3 * (sum(v[0] for v in kernels.values()) - convs) / t["frames"]
