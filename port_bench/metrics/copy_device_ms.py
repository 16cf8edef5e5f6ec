"""Device ms a frame of the host-to-device and device-to-host copies (the
batch's upload and readback), from the trace."""


def read(ctx):
    t = ctx.get("trace")
    if not ctx["cuda"] or not t or not t["frames"] or not t["copies"]:
        return None
    return 1e3 * sum(v[0] for v in t["copies"].values()) / t["frames"]
