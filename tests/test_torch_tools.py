"""The port's serving and model tools against the JAX package's, on the CPU.

- ``utils.subproc.wait_for_line``: the JAX package's four cases
  (``tests/test_subproc.py``) on the port's copy;
- ``models.summary.summarize``: the JAX text, line for line, for the same
  parameters (pix_shuffle, and conv3 with its BatchNorm buffers);
- ``models.benchmark.main`` at 32x32 for 0.2 s on the CPU (pix_shuffle, and
  conv3 and conv5 with BatchNorm folded): its report, with JAX's parameter
  count;
- ``export.streaming.measure_stream_throughput`` on a small frame: the
  frames it reports and the enhance calls it makes (warm-up included);
- ``runtime.sidecar_replay --loops 2``: each saved PNG holds the enhancement
  of the same-named input (mirrors ``tests/test_sidecar.py``'s test against
  the JAX server), against the port's server on a thread;
- ``chip_smoke.parallel_tools`` rehearsed at 48x80 (the server as a child
  process, every check; CPU times, never device times).
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
from fs_uae_image_enhancer_project_tpu_torch.export.streaming import measure_stream_throughput
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import benchmark
from fs_uae_image_enhancer_project_tpu_torch.models.summary import summarize
from fs_uae_image_enhancer_project_tpu_torch.runtime import sidecar, sidecar_replay
from fs_uae_image_enhancer_project_tpu_torch.utils.subproc import wait_for_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")


# ---------------------------------------------------------------------------
# wait_for_line (tests/test_subproc.py's cases)
# ---------------------------------------------------------------------------

def _spawn(code):
    return subprocess.Popen([sys.executable, "-u", "-c", code],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_wait_for_line_token_found():
    proc = _spawn("print('warming'); print('READY now'); "
                  "import time; time.sleep(30)")
    t0 = time.monotonic()
    ok, lines = wait_for_line(proc, "READY", timeout=20)
    assert ok and any("READY" in l for l in lines)
    assert time.monotonic() - t0 < 15
    proc.kill()
    proc.wait()


def test_wait_for_line_silent_child_times_out():
    proc = _spawn("import time; time.sleep(60)")
    t0 = time.monotonic()
    ok, lines = wait_for_line(proc, "READY", timeout=2)
    assert not ok and lines == []
    assert time.monotonic() - t0 < 10
    proc.kill()
    proc.wait()


def test_wait_for_line_retry_after_timeout_sees_token():
    proc = _spawn("import time; time.sleep(4); print('READY late'); "
                  "time.sleep(30)")
    ok, _ = wait_for_line(proc, "READY", timeout=1)
    assert not ok
    time.sleep(5)  # token is printed while no consumer is waiting
    ok, lines = wait_for_line(proc, "READY", timeout=20)
    assert ok and any("READY" in l for l in lines)
    proc.kill()
    proc.wait()


def test_wait_for_line_eof_returns_false():
    proc = _spawn("print('goodbye')")
    ok, lines = wait_for_line(proc, "READY", timeout=20)
    assert not ok and lines == ["goodbye\n"]
    proc.wait()


# ---------------------------------------------------------------------------
# models.summary and models.benchmark
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["pix_shuffle", "conv3"])
def test_summarize_text_equals_jax(name):
    import jax

    from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
    from fs_uae_image_enhancer_project_tpu.models.summary import summarize as jax_summarize

    jparams = jax.tree_util.tree_map(np.asarray, jax_model(name).init(jax.random.key(0)))
    want = jax_summarize(jparams, name)
    got = summarize(params_from_jax(jparams, device="cpu"), name)
    assert got.splitlines() == want.splitlines()
    # conv3's BatchNorm running stats are flagged
    assert any(line.endswith("buffer") for line in got.splitlines()) == (name == "conv3")


# the three forwards it runs differently: K1's plain version, and the two
# BatchNorm stacks folded first (conv6 and the U-Net take their apply as is)
@pytest.mark.parametrize("name", ["pix_shuffle", "conv3", "conv5"])
def test_benchmark_main_on_the_cpu(name, capsys):
    import jax

    from fs_uae_image_enhancer_project_tpu.models import count_params
    from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model

    assert benchmark.main(["--model_type", name, "--crop_size", "32", "32",
                           "--duration", "0.2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Using device: cpu" in out
    assert "Model output shape: (1, 32, 32, 3)" in out
    n = count_params(jax_model(name).init(jax.random.key(0)))
    assert f"Model size (trainable parameters): {n}" in out
    numbers = cs._bench_numbers(out)
    assert numbers["ms"] > 0 and numbers["fps"] > 0


# ---------------------------------------------------------------------------
# measure_stream_throughput and the replay client
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_measure_stream_throughput_on_the_cpu(depth):
    enhance = enhance_from_onnx(ONNX, device="cpu")
    calls = []

    def counted(x):
        calls.append(tuple(x.shape))
        return enhance(x)

    r = measure_stream_throughput(counted, depth=depth, n_frames=6, frame_shape=(16, 24, 4),
                                  device="cpu")
    assert r["frames"] == 6 and r["depth"] == depth
    assert r["fps_end_to_end"] > 0
    assert r["ms_per_frame"] == pytest.approx(1e3 / r["fps_end_to_end"])
    assert calls == [(1, 16, 24, 4)] * (6 + depth + 2)
    with pytest.raises(ValueError, match="depth"):
        measure_stream_throughput(counted, depth=0, device="cpu")


def test_replay_loops_pair_responses_by_position(tmp_path):
    """sidecar_replay --loops 2: every saved PNG must hold the enhancement of
    the SAME-named input (responses come back delayed by the depth, and a
    name repeats across loops)."""
    from PIL import Image

    h, w = 16, 24
    frames_dir, out_dir = tmp_path / "frames", tmp_path / "out"
    frames_dir.mkdir()
    rng = np.random.default_rng(77)
    frames = [rng.integers(0, 256, (h, w, 4), np.uint8) for _ in range(4)]
    for i, f in enumerate(frames):
        Image.fromarray(f, mode="RGBA").save(frames_dir / f"s{i}.png")

    def invert(x):
        out = (255 - x).clone()
        out[..., 3] = 255
        return out

    sock = str(tmp_path / "s.sock")
    server = sidecar.SidecarServer(invert, sock, height=h, width=w, depth=2, verbose=0,
                                   device="cpu", client_timeout=30.0)
    server.bind()
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    rc = sidecar_replay.main(["--socket", sock, "--frames", str(frames_dir),
                              "--out", str(out_dir), "--loops", "2", "--shutdown"])
    th.join(timeout=30)
    assert rc == 0 and not th.is_alive()
    for i, f in enumerate(frames):
        saved = np.asarray(Image.open(out_dir / f"s{i}.png"))
        np.testing.assert_array_equal(saved[..., :3], 255 - f[..., :3])
    assert server.latency_stats()["frames"] == 8


def test_replay_needs_frames(tmp_path, capsys):
    with pytest.raises(SystemExit):
        sidecar_replay.main(["--socket", str(tmp_path / "s.sock")])
    assert sidecar_replay.main(["--socket", str(tmp_path / "s.sock"),
                                "--frames", str(tmp_path)]) == 1
    assert "no frames under" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# chip_smoke.py's parallel_tools phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_parallel_tools_phase_on_the_cpu(monkeypatch):
    import statistics

    def median_ms(fn, n=50, warmup=10):  # CUDA events need a card
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    monkeypatch.setattr(cs, "median_ms", median_ms)
    cpu = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # small shapes: keep the suite's workers from contending
    try:
        rec = cs.parallel_tools(cpu, frame_hw=(48, 80), stream_frames=6, dir_frames=5,
                                bench_duration=0.2, bench_crop=(80, 48), latency_frames=10)
    finally:
        torch.set_num_threads(threads)
    cs.check_parallel_tools(rec, cpu)
    assert [s["depth"] for s in rec["stream"]] == [1, 2]
    assert rec["enhance_directory"] == dict(frames=5, batch_size=4, byte_equal=True)
    assert rec["replay"]["server_stats"]["depth"] == 2
    assert rec["replay"]["client"]["frames"] == 10
    assert [(r["depth"], r["server_stats"]["frames"]) for r in rec["latency"]] == [(0, 10), (2, 10)]
    assert [s["sp"] for s in rec["split"]] == [2, 4]
    assert all(s["max_abs"] == 0.0 for s in rec["split"])
    assert not any(rec["launches"].values())  # the CPU runs K1's plain version
