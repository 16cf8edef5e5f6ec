"""Where the time of the fused-stack kernels (K1 and K2) goes, phase by phase.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.profile_fused_stack [--out FILE]

The kernels carry their own probe, for where no profiler (``ncu``,
``nsys``) can attach: built with ``-DFSE_PROFILE``, thread 0 of each CTA of the
first frame records ``clock64()`` at the phase boundaries
(``csrc/fused_stack_common.cuh``). This script builds that library beside
the shipped one, runs each kernel on the served path's input
(``sweep_fused_stack.frame_input``, shipped weights), averages each phase
over the CTAs, and converts cycles to microseconds at the SM clock that
``nvidia-smi`` reads during the run. A layer's epilogue phase runs from the
end of its K loop to the start of the next layer's, so it holds the
layer-end barrier and the wait for the slowest warp. It also times both
builds (``utils.profiler.device_times``), so the probe's own cost shows.
One JSON line a kernel, and all of them to ``--out`` if given. Needs a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROFILE_CTAS, PROFILE_STAMPS = 1024, 18  # as in csrc/fused_stack_common.cuh

# (phase, first stamp, last stamp), one after the other from the start (0) to
# the end (16); stamps 2L and 2L+1 bound layer L's K loop
PHASES = (("input", 0, 2), ("l1 K", 2, 3), ("l1 epilogue", 3, 4), ("l2 K", 4, 5),
          ("l2 epilogue", 5, 17), ("l1 compaction", 17, 6), ("l3 K", 6, 7),
          ("l3 epilogue", 7, 8), ("l4 K", 8, 9), ("l4 epilogue", 9, 10), ("l5 K", 10, 11),
          ("l5 epilogue", 11, 12), ("l6 K", 12, 13), ("l6 epilogue", 13, 14), ("l7 K", 14, 15),
          ("l7 epilogue", 15, 16))


def phases(stamps: np.ndarray) -> dict:
    """Mean cycles of each phase over the CTAs that recorded a whole run
    (stamps: (CTAs, PROFILE_STAMPS) clock64 values), with their total."""
    t = stamps.astype(np.int64)
    t = t[(t[:, 0] > 0) & (t[:, 16] > t[:, 0])]
    if not len(t):
        raise ValueError("no CTA recorded a whole run")
    out = {name: float(np.mean(t[:, b] - t[:, a])) for name, a, b in PHASES}
    out["total"] = float(np.mean(t[:, 16] - t[:, 0]))
    out["ctas"] = int(len(t))
    return out


def sm_clock_mhz(run) -> float:
    """The median SM clock nvidia-smi reads every 100 ms while ``run()``
    keeps the card busy."""
    p = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                          "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        run()
    finally:
        p.terminate()
        out = p.communicate(timeout=30)[0]
    mhz = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    if not mhz:
        raise RuntimeError("nvidia-smi read no SM clock")
    return statistics.median(mhz)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_fused_stack: needs a CUDA card", file=sys.stderr)
        return 2

    from ..export.onnx_import import import_pix_shuffle
    from ..interop import params_from_jax
    from ..ops.cuda import build
    from ..ops.cuda import fused_stack as fs
    from ..ops.cuda import fused_stack_packed as k2
    from ..utils.profiler import device_times
    from .sweep_fused_stack import ONNX, frame_input

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    shipped = build.load_library()
    probed = build.load_library(defines=("FSE_PROFILE",))
    imp = import_pix_shuffle(ONNX)
    params = params_from_jax(imp.params, device=dev)
    u = frame_input(dev, imp.crop_left, imp.srgb_to_linear_exponent)
    recs = []
    for entry, sw in (("fse_fused_stack", fs.prepare_weights(params, dev)),
                      ("fse_fused_stack_packed", k2.prepare_weights(params, dev))):
        def launch(lib, e=entry, s=sw):
            return fs.launch_stack(e, u, s, lib)

        times = {"shipped": device_times(lambda: launch(shipped)),
                 "probed": device_times(lambda: launch(probed))}

        def busy():
            for _ in range(2000):
                launch(probed)
            torch.cuda.synchronize()

        mhz = sm_clock_mhz(busy)
        stamps = np.zeros((PROFILE_CTAS, PROFILE_STAMPS), np.uint64)
        rc = getattr(probed, entry + "_profile")(stamps.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise RuntimeError(f"{entry}_profile failed: CUDA error {rc}")
        cyc = phases(stamps)
        us = {k: v / mhz for k, v in cyc.items() if k != "ctas"}
        rec = dict(kernel=entry, shape=list(u.shape), nvidia_smi=smi, sm_clock_mhz=mhz,
                   ctas=cyc["ctas"], tile_us=us,
                   share={k: v / us["total"] for k, v in us.items() if k != "total"},
                   ms_shipped=times["shipped"]["ms"], ms_probed=times["probed"]["ms"])
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
