"""Device ms a frame of every kernel of the enhance call other than the
stack's (the prologue and epilogue of ``export/enhance.py``), from the trace;
copies are not kernels here."""
from port_bench.harness import trace


def read(ctx):
    t = ctx.get("trace")
    if not ctx["cuda"] or not t or not t["frames"]:
        return None
    kernels = t["kernels"]
    total = sum(v[0] for v in kernels.values())
    stack = trace.matching(kernels, ctx["config"]["main_layer"]["kernels"])
    if stack <= 0:
        return None
    return 1e3 * (total - stack) / t["frames"]
