"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (``--device cpu``, a small frame), the rest
of a run as it is, once for each fault a cell can have. The cells run one
card and train nothing, so a state left unchanged and a lost exchange
between cards cannot happen; these can:

- half of a batch left out: the frames of a call's second half get the
  first half's answers;
- an answer altered where it is produced: each call's first frame comes
  back shifted by eight pixels (offline), every reply of the frame server
  does (served)."""
import io
import json
import os
import shutil
import sys
import textwrap
from contextlib import redirect_stdout

import pytest
import torch

import fs_uae_image_enhancer_project_tpu_torch.export.enhance as port_enhance
from port_bench import run
from port_bench.harness import manifest
from port_bench.harness import served as sv

ARGS = ["--seed", "77", "--seconds", "1", "--trace", "0", "--device", "cpu", "--frame", "48x80"]


def half_batch(out):
    half = out.shape[0] // 2
    out[half:2 * half] = out[:half].clone()
    return out


def altered(out):
    out[0] = torch.roll(out[0], 8, dims=1)
    return out


def _result(cell):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert run.main(["--workload", cell] + ARGS) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _broken(monkeypatch, fault):
    real = port_enhance.enhance_from_onnx

    def enhance_from_onnx(*args, **kwargs):
        fn = real(*args, **kwargs)
        return lambda frames: fault(fn(frames))

    monkeypatch.setattr(port_enhance, "enhance_from_onnx", enhance_from_onnx)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("cell", ["pix_shuffle.offline_b8", "conv6.offline_b8"])
def test_the_sound_run_is_correct(cell):
    assert _result(cell)["correct"] is True


@pytest.mark.parametrize("cell", ["pix_shuffle.offline_b8", "conv6.offline_b8"])
@pytest.mark.parametrize("fault", [half_batch, altered], ids=["half_batch", "altered"])
def test_an_offline_fault_is_not_correct(cell, fault, monkeypatch):
    _broken(monkeypatch, fault)
    line = _result(cell)
    assert line["correct"] is False
    assert not line["checks"]["worst_mae_levels"]["ok"]


def test_an_altered_reply_of_the_server_is_not_correct(tmp_path, monkeypatch):
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("no C compiler to build the load generator")
    script = tmp_path / "broken_server.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {manifest.ROOT!r})
        import torch
        from port_bench.harness import server

        real = server.program_enhance

        def program_enhance(config, device):
            fn = real(config, device)
            return lambda frames: torch.roll(fn(frames), 8, dims=2)

        server.program_enhance = program_enhance
        sys.exit(server.main())
    """))
    monkeypatch.setattr(sv, "server_command", lambda: [sys.executable, str(script)])
    line = _result("conv6.served_1x50")
    assert line["correct"] is False
    assert not line["checks"]["worst_mae_levels"]["ok"]
