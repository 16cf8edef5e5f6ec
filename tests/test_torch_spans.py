"""The port's spans (``utils/profiler.py`` ``span``) on the CPU: a shared
no-op while no profiler records, ``record_function`` marks nested as the frame
path's layers while one does, every name listed in ``SPANS``, and ``span`` the
one way into ``record_function``."""
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fs_uae_image_enhancer_project_tpu_torch as port
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import default_enhance_fn
from fs_uae_image_enhancer_project_tpu_torch.parallel.mesh import make_mesh, shard_batch
from fs_uae_image_enhancer_project_tpu_torch.utils import profiler
from fs_uae_image_enhancer_project_tpu_torch.utils.profiler import SPANS, span

PACKAGE = os.path.dirname(os.path.abspath(port.__file__))
ENHANCE_CHILDREN = ("fse.enhance.prologue", "fse.enhance.model", "fse.enhance.epilogue")


def _sources():
    for folder, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(folder, f)
                with open(path) as fh:
                    yield os.path.relpath(path, PACKAGE), fh.read()


def _recorded(fn):
    """The ``fse.`` host events of one profiled call of ``fn``, as
    ``(name, start_ns, end_ns)`` in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("fse.")]
    return sorted(events, key=lambda t: t[1])


def _frame():
    return np.random.default_rng(0).integers(0, 256, (1, 48, 80, 4), dtype=np.uint8)


@pytest.fixture(scope="module")
def enhance():
    return default_enhance_fn(device="cpu")[0]


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    off = span("fse.enhance")
    assert off is span("fse.upload") is profiler._OFF
    with off:
        with span("fse.enhance.model"):  # the shared context nests
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("fse.enhance") is not off


def test_one_enhance_call_records_its_span_and_three_children(enhance):
    enhance(_frame())  # the first call's one-off work stays out of the trace
    got = _recorded(lambda: enhance(_frame()))
    names = [n for n, _, _ in got]
    assert names.count("fse.enhance") == 1
    assert names == ["fse.enhance", *ENHANCE_CHILDREN]  # no upload: the frames are on its device
    _, a, b = got[0]
    children = got[1:]
    assert all(a <= s and e <= b for _, s, e in children)
    assert all(e1 <= s2 for (_, _, e1), (_, s2, _) in zip(children, children[1:]))


def test_a_host_batch_uploads_inside_enhance_before_the_prologue():
    fn, _ = default_enhance_fn(device="meta")  # params on another device than the host frames
    got = _recorded(lambda: fn(_frame()))
    names = [n for n, _, _ in got]
    assert names == ["fse.enhance", "fse.upload", *ENHANCE_CHILDREN]
    (_, a, b), (_, ua, ub), (_, pa, _) = got[:3]
    assert a <= ua and ub <= b and ub <= pa


def test_one_shard_batch_call_records_one_upload():
    mesh = make_mesh(sp=1, device="cpu")
    got = _recorded(lambda: shard_batch(mesh, np.zeros((2, 8, 8, 4), np.uint8),
                                        split_height=False))
    assert [n for n, _, _ in got] == ["fse.upload"]


def test_every_span_the_port_opens_is_listed():
    opened = set()
    for rel, text in _sources():
        opened |= set(re.findall(r"""(?<!def )\bspan\(\s*["']([^"']+)["']""", text))
        by_variable = re.search(r"""(?<!def )\bspan\(\s*[^\s"']""", text)
        assert not by_variable, f"{rel} names a span by a variable"
    assert opened == set(SPANS)
    assert len(SPANS) == len(set(SPANS)) and all(n.startswith("fse.") for n in SPANS)


def test_the_spans_recorded_on_the_frame_path_are_listed(enhance):
    mesh = make_mesh(sp=1, device="cpu")
    got = _recorded(lambda: enhance(shard_batch(mesh, _frame(), split_height=False)))
    assert {n for n, _, _ in got} <= set(SPANS)
    assert [n for n, _, _ in got].count("fse.upload") == 1


def test_only_the_profiler_module_calls_record_function():
    callers = sorted(rel for rel, text in _sources() if re.search(r"\brecord_function\b", text))
    assert callers == [os.path.join("utils", "profiler.py")]
