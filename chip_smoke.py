"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall time:

1. device     the card (nvidia-smi name and power limit, torch's name)
2. build      nvcc build of the port's kernels (time, ptxas registers/spills)
3. k1_parity  the fused-stack kernel (K1) against its plain PyTorch version,
              shipped weights, seeded inputs, half-res 288x376 and 288x368
4. enhance    8 seeded 576x752 RGBA frames through enhance_from_onnx on cuda
5. server     the port's frame server at depth 0 and 2 (the main path): every
              launch counter is set to 0 just before and read just after
6. timing     CUDA-event medians of K1, its plain version, cuDNN, the enhance
7. kernels    every kernel launched, held against its plain version

Then the card's nvidia-smi line and the kernels line, and last the contract
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
prints no result; a watchdog ends the run with exit 3 at 600 s. Needs one
CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

WATCHDOG_S = 600
REPO = os.path.dirname(os.path.abspath(__file__))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
K1_SOURCE = "fs_uae_image_enhancer_project_tpu_torch/ops/cuda/csrc/fused_stack.cu"
K1_REPLACES = "fs_uae_image_enhancer_project_tpu/ops/pallas/fused_stack.py:204"
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
K1_MAX_ABS, K1_MEAN_ABS = 6e-3, 6e-4
PSNR_MIN_DB = 50.0

_phase = "start"


def _watchdog() -> None:
    time.sleep(WATCHDOG_S)
    print(json.dumps({"phase": _phase, "error": f"watchdog: over {WATCHDOG_S} s"}),
          flush=True)
    os._exit(3)


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter() - t0, 3),
                      **fields}), flush=True)


def psnr(a, b) -> float:
    import numpy as np

    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def median_ms(fn, n: int = 50, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def library_stack(u, sw):
    """The K1 function as eager bf16 torch (cuDNN convs): the yardstick timed
    as library_ms. The port never calls it."""
    import torch
    import torch.nn.functional as F

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.fused_stack import PARAM_OFFSETS

    bf = torch.bfloat16
    p = sw.prm.to(bf)

    def v(name, n, shape=(1, -1, 1, 1)):
        o, _ = PARAM_OFFSETS[name]
        return p[o:o + n].view(shape)

    def conv(x, i, cout):
        o, _ = PARAM_OFFSETS[f"b{i + 1}"]
        return F.conv2d(x, sw.plain[i].to(bf), p[o:o + cout], padding=1)

    sc = v("scalars", 6, (6,))

    def sinlu(x, a, b):
        return torch.sigmoid(x) * (x + a * torch.sin(b * x))

    def bprelu(x, bias, slope):
        s = x - bias
        return torch.where(s >= 0, s, slope * s)

    x = u.permute(2, 0, 1)[None]
    l1 = sinlu(conv(x, 0, 36), sc[0], sc[1]).clamp(0, 6)
    t = conv(l1, 1, 36)
    t = t * torch.tanh(torch.exp(t)) + l1
    l2 = bprelu(sinlu(t, sc[2], sc[3]), v("p2b", 36), v("p2s", 36))
    l3 = conv(l2, 2, 72)
    l4 = torch.relu(torch.tanh(bprelu(F.mish(conv(l3, 3, 72)), v("p4b", 72), v("p4s", 72)) + l3))
    l5 = conv(l4, 4, 36)
    l6 = F.mish(conv(torch.cat([l1, l5], 1), 5, 36)).clamp(0, 6)
    return bprelu(conv(l6, 6, 12), sc[4], sc[5])[0].permute(1, 2, 0)


def main() -> int:
    global _phase
    threading.Thread(target=_watchdog, daemon=True).start()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import numpy as np

    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import (
        enhance_from_onnx, make_enhance_fn)
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
    from fs_uae_image_enhancer_project_tpu_torch.ops.pixel_shuffle import pixel_unshuffle
    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import (
        SidecarClient, SidecarServer)

    dev = torch.device("cuda")
    # the plain version is the fp32 reference: no TF32 in cuDNN's convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    _phase = "device"
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    _phase = "build"
    t0 = time.perf_counter()
    lib = build.load_library()
    ptxas = [line.strip() for line in build.build_info["ptxas"].splitlines()
             if any(k in line for k in ("Compiling entry", "registers", "spill", "smem"))]
    emit("build", t0, build_seconds=round(build.build_info["seconds"], 3),
         built=build.build_info["built"], smem_bytes=lib.fse_fused_stack_smem_bytes(),
         ptxas=ptxas)

    # 3. k1_parity: shipped weights, seeded linear-light inputs
    _phase = "k1_parity"
    t0 = time.perf_counter()
    imp = import_pix_shuffle(ONNX)
    params = params_from_jax(imp.params, device=dev)
    sw = fs.prepare_weights(params, dev)
    gen = torch.Generator().manual_seed(0)
    k1_err, shapes = 0.0, []
    for h2, w2 in ((288, 376), (288, 368)):
        u = (torch.rand(h2, w2, 12, generator=gen) ** 2.2).to(torch.bfloat16).to(dev)
        y = fs.fused_stack(u, sw).float()
        ref = fs.fused_stack_plain(u, sw, out_fp32=True)
        torch.cuda.synchronize()
        err = (y - ref).abs()
        row, col = err.amax(dim=(1, 2)), err.amax(dim=(0, 2))
        seam_r = torch.tensor([r for r in range(h2) if r % 16 in (0, 15)])
        seam_c = torch.tensor([c for c in range(w2) if c % 16 in (0, 15)])
        rec = dict(shape=[h2, w2], max_abs=err.max().item(), mean_abs=err.mean().item(),
                   seam_row_max=row[seam_r.to(dev)].max().item(),
                   seam_col_max=col[seam_c.to(dev)].max().item(),
                   row_max_top5=sorted(row.tolist(), reverse=True)[:5],
                   finite=bool(torch.isfinite(y).all()))
        shapes.append(rec)
        k1_err = max(k1_err, rec["max_abs"])
    emit("k1_parity", t0, cudnn_allow_tf32=False, tol_max_abs=K1_MAX_ABS,
         tol_mean_abs=K1_MEAN_ABS, shapes=shapes)
    for rec in shapes:
        check(rec["finite"], f"K1 output not finite at {rec['shape']}")
        check(rec["max_abs"] <= K1_MAX_ABS, f"K1 max abs {rec['max_abs']} > {K1_MAX_ABS}")
        check(rec["mean_abs"] <= K1_MEAN_ABS, f"K1 mean abs {rec['mean_abs']} > {K1_MEAN_ABS}")

    # 4. enhance: the entry point on cuda vs the same run with the plain stack
    _phase = "enhance"
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, 576, 752, 4), dtype=np.uint8)
    enhance = enhance_from_onnx(ONNX, device=dev)
    enhance_plain = make_enhance_fn(
        fs.fused_stack_apply_plain, params, crop_left=imp.crop_left,
        srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
        linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=dev)
    before = fs.fused_stack.launches
    outs = [enhance(frames[i:i + 1]).cpu().numpy() for i in range(8)]
    rose = fs.fused_stack.launches - before
    plain = [enhance_plain(frames[i:i + 1]).cpu().numpy() for i in range(8)]
    psnrs = [psnr(a, b) for a, b in zip(outs, plain)]
    emit("enhance", t0, frames=8, crop_left=imp.crop_left, psnr_db_min=min(psnrs),
         psnr_db_mean=statistics.mean(psnrs), k1_launches=rose)
    for o in outs:
        check(o.shape == (1, 576, 752, 4) and o.dtype == np.uint8, f"bad output {o.shape} {o.dtype}")
        check(bool((o[..., 3] == 255).all()), "alpha is not 255")
    check(min(psnrs) >= PSNR_MIN_DB, f"enhance PSNR {min(psnrs)} dB < {PSNR_MIN_DB}")
    check(rose == 8, f"K1 launches rose by {rose}, not 8")

    # 5. server: the main path, every counter from 0
    _phase = "server"
    t0 = time.perf_counter()
    fs.fused_stack.launches = 0
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        for depth in (0, 2):
            sock = os.path.join(tmp, f"fse{depth}.sock")
            server = SidecarServer(enhance, sock, depth=depth, verbose=0, device=dev,
                                   client_timeout=60.0)
            server.warmup()
            server.bind()
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            client = SidecarClient(sock, timeout=60.0)
            try:
                got = []
                for i in range(6):
                    r = client.submit(frames[i])
                    if r is not None:
                        got.append(r)
                got += client.drain()
                client.shutdown_server()
            finally:
                client.close()
            th.join(timeout=10)
            check(not th.is_alive(), f"server thread (depth {depth}) did not join in 10 s")
            check(len(got) == 6, f"depth {depth}: {len(got)} responses for 6 frames")
            equal = all(np.array_equal(g, outs[i][0]) for i, g in enumerate(got))
            check(equal, f"depth {depth}: responses differ from the direct enhance")
            served[f"depth{depth}"] = dict(frames=len(got), byte_equal=equal)
    launches = {"fused_stack": fs.fused_stack.launches}
    check(launches["fused_stack"] > 0, "the server ran without launching K1")
    emit("server", t0, launches=launches, **served)

    # 6. timing at the main path's shape
    _phase = "timing"
    t0 = time.perf_counter()
    x = (torch.from_numpy(frames[0, :, imp.crop_left:, :3]).to(dev).float() / 255.0)
    x = x ** imp.srgb_to_linear_exponent
    u = pixel_unshuffle(x[None], 2)[0].to(torch.bfloat16).contiguous()
    h2, w2 = u.shape[:2]
    k1_ms = median_ms(lambda: fs.fused_stack(u, sw))
    plain_ms = median_ms(lambda: fs.fused_stack_plain(u, sw))
    library_ms = median_ms(lambda: library_stack(u, sw))
    frame_dev = torch.from_numpy(frames[:1]).to(dev)
    enhance_ms = median_ms(lambda: enhance(frame_dev))
    flops = 2.0 * fs.MACS_PER_PIXEL * h2 * w2
    nbytes = (2 * u.numel() * u.element_size()
              + sum(w.numel() * w.element_size() for w in sw.frags)
              + sw.prm.numel() * sw.prm.element_size())
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    emit("timing", t0, shape=[h2, w2, 12], gflop=flops / 1e9, mbytes=nbytes / 1e6,
         k1_ms=k1_ms, bound_ms=bound_ms, share_of_bound=bound_ms / k1_ms,
         plain_ms=plain_ms, library_ms=library_ms, enhance_ms_per_frame=enhance_ms,
         enhance_fps=1e3 / enhance_ms, nvidia_smi=smi)

    # 7. kernels
    _phase = "kernels"
    kernels = [dict(
        name="fused_stack", route="cuda", source=K1_SOURCE, replaces=K1_REPLACES,
        counterpart="ops/pallas/fused_stack.py::_stack_kernel",
        launches=launches["fused_stack"], max_abs_err=k1_err, ms=k1_ms, kernel_ms=k1_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if ops_ms >= bytes_ms else "bytes", library_ms=library_ms)]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # report the phase, then fail
        print(json.dumps({"phase": _phase, "error": f"{type(e).__name__}: {e}"}), flush=True)
        raise
    sys.exit(rc)
