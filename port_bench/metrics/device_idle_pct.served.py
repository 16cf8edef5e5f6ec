"""The share of the traced slice in which neither a kernel nor a copy ran on
the device, in the served cells."""


def read(ctx):
    t = ctx.get("trace")
    if not ctx["cuda"] or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
