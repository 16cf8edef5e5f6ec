"""The emulator's C client (``runtime/sidecar_client.c``) against the port's
frame server, on the CPU.

The replay tool is compiled into a temporary directory by
``chip_smoke.compile_replay`` (``cc -O2 -std=c11 -DFSE_REPLAY_MAIN``) and
sends one seeded 576x752 frame 4 times to the port's ``SidecarServer``,
served in this process at depth 2 with the plain enhance of the shipped
pix_shuffle graph. Its last frame must
be the bytes the port's Python client gets for the same frame, with alpha
255. Skips only where no C compiler is found, as the JAX package's
``tests/test_sidecar.py`` does.
"""
import shutil
import subprocess
import threading

import numpy as np
import pytest

import chip_smoke as cs
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
from fs_uae_image_enhancer_project_tpu_torch.runtime import sidecar

H, W, DEPTH, LOOPS = 576, 752, 2, 4


def test_c_replay_tool_against_the_port_server(tmp_path):
    if not (shutil.which("cc") or shutil.which("gcc")):
        pytest.skip("no C compiler found")
    binary = cs.compile_replay(str(tmp_path))
    frame = np.random.default_rng(3).integers(0, 256, (H, W, 4), dtype=np.uint8)
    raw_in, raw_out = str(tmp_path / "in.raw"), str(tmp_path / "out.raw")
    frame.tofile(raw_in)
    srv = sidecar.SidecarServer(enhance_from_onnx(cs.ONNX, device="cpu"),
                                str(tmp_path / "s.sock"), height=H, width=W, depth=DEPTH,
                                verbose=0, device="cpu", client_timeout=60.0)
    srv.bind()
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        r = subprocess.run([binary, srv.socket_path, raw_in, raw_out, str(LOOPS)],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert f'"frames": {LOOPS}' in r.stdout and f'"depth": {DEPTH}' in r.stdout
        client = sidecar.SidecarClient(srv.socket_path, timeout=60.0)
        try:
            assert client.submit(frame) is None  # depth 2: the pipeline fills
            expect = client.drain()[0]
            client.shutdown_server()
        finally:
            client.close()
    finally:
        th.join(timeout=30)
    assert not th.is_alive()
    out = np.fromfile(raw_out, np.uint8).reshape(H, W, 4)
    assert np.all(out[..., 3] == 255)
    np.testing.assert_array_equal(out, expect)
    assert srv.latency_stats()["frames"] == LOOPS + 1
