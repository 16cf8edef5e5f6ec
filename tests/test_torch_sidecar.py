"""The port's frame server on the CPU: wire protocol, pipelining, timeouts.

The server serves 3 frames at depth 0 and depth 2 over a unix socket, in a
thread, to the port's client; every socket has a timeout and every join a
bound, so a fault fails the test instead of hanging it. With a trivial
enhance, its latency record is read while a client is connected and after a
client drops mid-stream.
"""
import os
import socket
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from fs_uae_image_enhancer_project_tpu.runtime import sidecar as jax_sidecar
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
from fs_uae_image_enhancer_project_tpu_torch.export.streaming import FrameStream
from fs_uae_image_enhancer_project_tpu_torch.runtime import sidecar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
H, W = 32, 48
FRAMES = np.random.default_rng(0).integers(0, 256, (3, H, W, 4), dtype=np.uint8)


@pytest.fixture(scope="module")
def enhance():
    return enhance_from_onnx(ONNX, device="cpu")


def test_wire_protocol_is_byte_identical_to_the_jax_server():
    for name in ("MAGIC", "VERSION", "OP_FRAME", "OP_DRAIN", "OP_SHUTDOWN",
                 "RE_FRAME", "RE_DRAIN_DONE"):
        assert getattr(sidecar, name) == getattr(jax_sidecar, name), name
    assert sidecar.HANDSHAKE.format == jax_sidecar.HANDSHAKE.format
    hs = (b"FSE1", 1, 2, 576, 752, 4, b"\0" * 5)
    assert sidecar.HANDSHAKE.pack(*hs) == jax_sidecar.HANDSHAKE.pack(*hs)


@pytest.mark.parametrize("depth", [0, 2])
def test_server_answers_frames(enhance, depth):
    direct = [enhance(FRAMES[i:i + 1]).numpy()[0] for i in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.sock")
        srv = sidecar.SidecarServer(enhance, path, height=H, width=W, depth=depth,
                                    verbose=0, device="cpu", client_timeout=30.0)
        srv.warmup()
        srv.bind()
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        client = sidecar.SidecarClient(path, timeout=30.0)
        try:
            assert (client.depth, client.h, client.w) == (depth, H, W)
            got = []
            for i in range(3):
                out = client.submit(FRAMES[i])
                assert (out is None) == (depth > 0 and i < depth)
                if out is not None:
                    got.append(out)
            got += client.drain()
            client.shutdown_server()
        finally:
            client.close()
        th.join(timeout=10)
        assert not th.is_alive()
        assert not os.path.exists(path)
    assert len(got) == 3
    for a, b in zip(got, direct):
        np.testing.assert_array_equal(a, b)
    stats = srv.latency_stats()
    assert stats["frames"] == 3 and stats["depth"] == depth


def test_silent_client_is_dropped_after_its_timeout(enhance):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.sock")
        srv = sidecar.SidecarServer(enhance, path, height=H, width=W, depth=0,
                                    verbose=0, device="cpu", client_timeout=0.5)
        srv.bind()
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        idle = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        idle.settimeout(10.0)
        idle.connect(path)
        assert len(idle.recv(sidecar.HANDSHAKE.size)) == sidecar.HANDSHAKE.size
        assert idle.recv(1) == b""  # the server closed the silent session
        idle.close()
        client = sidecar.SidecarClient(path, timeout=10.0)
        client.shutdown_server()
        client.close()
        th.join(timeout=10)
        assert not th.is_alive()


def test_client_times_out_instead_of_hanging():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mute.sock")
        mute = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        mute.bind(path)
        mute.listen(1)
        try:
            with pytest.raises(socket.timeout):
                sidecar.SidecarClient(path, timeout=0.3)  # no handshake comes
        finally:
            mute.close()


def test_server_validates_its_arguments(enhance):
    with pytest.raises(ValueError):
        sidecar.SidecarServer(enhance, "/nonexistent/x.sock", depth=256, device="cpu")
    bad = sidecar.SidecarServer(lambda f: torch.zeros(1, 2, 2, 4, dtype=torch.uint8),
                                "/nonexistent/x.sock", height=H, width=W, device="cpu")
    with pytest.raises(ValueError):
        bad.warmup()


@pytest.mark.parametrize("depth", [1, 2])
def test_frame_stream_returns_frames_in_order(enhance, depth):
    stream = FrameStream(enhance, depth=depth, device="cpu", frame_shape=(H, W, 4))
    outs = [stream.submit(FRAMES[i]) for i in range(3)]
    assert all(o is None for o in outs[:depth])
    outs = [o for o in outs if o is not None] + list(stream.drain())
    assert len(outs) == 3 and len(stream) == 0
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, enhance(FRAMES[i:i + 1]).numpy())
    with pytest.raises(ValueError):
        FrameStream(enhance, depth=0, device="cpu")


def _serve_in_thread(srv):
    srv.bind()
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return th


def _stop(srv, th):
    client = sidecar.SidecarClient(srv.socket_path, timeout=10.0)
    client.shutdown_server()
    client.close()
    th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.parametrize("case", ["connected", "dropped"])
def test_latency_record_is_flushed_during_and_after_a_session(monkeypatch, case):
    """Every LAT_FLUSH frames a session folds its latencies into the record,
    so the stats show them while its client is connected; a session that
    ends in a socket error still counts the frames it served."""
    monkeypatch.setattr(sidecar.SidecarServer, "LAT_FLUSH", 8)
    gate, calls = threading.Event(), []

    def trivial(frames):  # alpha forced, as the enhance does
        calls.append(1)
        if case == "dropped" and len(calls) == 5:
            assert gate.wait(10.0)  # answer only after the client has gone
        return frames.clone().index_fill_(-1, torch.tensor([3]), 255)

    frames = np.random.default_rng(1).integers(0, 256, (20, 4, 6, 4), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        srv = sidecar.SidecarServer(trivial, os.path.join(tmp, "s.sock"), height=4, width=6,
                                    depth=0, verbose=0, device="cpu", client_timeout=30.0)
        th = _serve_in_thread(srv)
        client = sidecar.SidecarClient(srv.socket_path, timeout=10.0)
        if case == "connected":
            for f in frames:
                assert client.submit(f)[..., 3].min() == 255
            stats = srv.latency_stats()
            assert stats["frames"] == 16 and stats["percentile_window_frames"] == 16
            client.close()
        else:
            for f in frames[:4]:
                client.submit(f)
            assert srv.latency_stats() is None  # 4 frames: no flush yet
            # the fifth frame goes out, then the client is gone before its
            # answer: the server's send fails and the session ends in an error
            client.sock.sendall(bytes([sidecar.OP_FRAME]) + frames[4].tobytes())
            client.close()
            gate.set()
        deadline = time.monotonic() + 10.0
        want = 20 if case == "connected" else 5
        while (srv.latency_stats() or {}).get("frames") != want:
            assert time.monotonic() < deadline, srv.latency_stats()
            time.sleep(0.01)
        _stop(srv, th)
    stats = srv.latency_stats()
    assert stats["frames"] == want and 0 < stats["min_ms"] <= stats["max_ms"]
    assert set(stats) == {"frames", "percentile_window_frames", "depth", "p50_ms", "p90_ms",
                          "p99_ms", "min_ms", "max_ms", "mean_ms", "definition"}
