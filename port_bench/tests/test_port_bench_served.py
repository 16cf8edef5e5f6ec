"""The served cell's load generator (``harness/served_client.c``) against the
port's ``SidecarServer`` on the CPU at a small frame: every reply byte for
byte the direct enhance of its frame, and the open schedule's due times."""
import shutil
import socket
import threading

import numpy as np
import pytest
import torch

from port_bench.harness import manifest
from port_bench.harness import served as sv
from port_bench.harness.frames import recording
from port_bench.harness.graphs import graph_path

H, W = 48, 80
TRAFFIC = dict(clients=2, rate_hz=50, phases_ms=[0.0, 7.0], frames_per_client=4,
               warmup_frames=2, check_frames_per_client=1000, reply_wait_s=30)
SECONDS = 1.0


@pytest.fixture
def binary():
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("no C compiler to build the load generator")
    return sv.client_binary()


class _Served:
    """The port's frame server in a thread, as ``harness.served.Server`` runs it."""

    def __init__(self, fn, path):
        from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import SidecarServer

        self.socket = path
        self.server = SidecarServer(fn, path, height=H, width=W, depth=0, max_clients=2,
                                    verbose=0, device="cpu")
        self.server.warmup()
        self.server.bind()
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def tail(self):
        return ""

    def close(self):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(self.socket)
            s.recv(16)
            s.sendall(b"\x03")
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_replies_and_schedule(binary, tmp_path):
    from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx

    torch.set_num_threads(2)
    config = manifest.config("conv6")
    fn = enhance_from_onnx(graph_path(config), device="cpu")
    per = TRAFFIC["frames_per_client"]
    frames = recording(9, 2 * per, H, W, 32)
    phases, due, keep = sv.schedule(TRAFFIC, 9, SECONDS)
    assert sorted(phases) == [0, 7_000_000] and due == [50, 50]
    assert len(keep) == sum(due)  # every reply is kept
    server = _Served(fn, str(tmp_path / "s.sock"))
    try:
        got = sv.run_clients(binary, server, TRAFFIC, frames, SECONDS, phases, keep)
    finally:
        server.close()
    rec = got["records"]
    assert len(rec) == sum(due) and (rec[:, 5] == 1).all()
    for c in range(2):
        mine = rec[rec[:, 0] == c]
        assert (mine[:, 1] == np.arange(len(mine))).all()
        np.testing.assert_array_equal(mine[:, 2], got["t0_ns"] + phases[c] + mine[:, 1] * 20_000_000)
        assert (mine[:, 3] >= mine[:, 2]).all() and (mine[:, 4] > mine[:, 3]).all()
    expect = fn(torch.from_numpy(frames)).numpy()
    assert len(got["samples"]) == sum(due)
    for c, seq, ok, frame in got["samples"]:
        assert ok
        np.testing.assert_array_equal(frame, expect[c * per + seq % per])
    lat = sv.latencies_ms(rec)
    assert len(lat) == sum(due) and (lat > 0).all()
