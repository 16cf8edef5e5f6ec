"""The traced slice's reducers on synthetic events (``harness/trace.py`` and
the spans' split, ``harness/spans.py``), and the program's spans in a CPU
rehearsal of an offline cell."""
import json

import pytest

from port_bench.harness import manifest, spans, trace

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"
STACK = "void fse_stack::stack_kernel<1>(__nv_bfloat16 const*)"
HTOD = "Memcpy HtoD (Pageable -> Device)"
DTOH = "Memcpy DtoH (Device -> Pageable)"


class Event:
    """The part of a profiler event the reducers read: name, start (ns),
    duration (ns), device type and the user-annotation flag."""

    def __init__(self, name, start, duration, device=CPU, annotation=False):
        self._v = (name, start, duration, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


# A 10 us slice from t = 1000 ns. Device work (clipped to the slice):
# [1000, 1200] [1500, 4500] [8000, 9000] [10500, 11000]: busy 4700 ns, and
# the idle gaps [1200, 1500] [4500, 8000] [9000, 10500]: 5300 ns.
DEVICE = [
    Event(trace.MARK, 1000, 10000, CUDA, annotation=True),
    Event("early_kernel", 500, 700, CUDA),
    Event(HTOD, 1500, 500, CUDA),
    Event(STACK, 2000, 2000, CUDA),
    Event("elementwise_kernel", 3500, 1000, CUDA),
    Event(DTOH, 8000, 1000, CUDA),
    Event("late_kernel", 10500, 1500, CUDA),
]
HOST = [
    Event(trace.MARK, 1000, 10000),
    Event("cudaMemcpyAsync", 1200, 300),
    Event("cudaLaunchKernel", 5100, 100),
    Event("aten::copy_", 7950, 1150),  # the caller's readback
]
SPANS = [  # the program's spans: an upload, and a call of enhance
    Event("fse.enhance", 500, 550),  # a call cut by the slice's start
    Event("fse.upload", 1100, 400),
    Event("fse.enhance", 4600, 3300),
    Event("fse.enhance.prologue", 4700, 300),
    Event("fse.enhance.model", 5000, 2000),
    Event("fse.enhance.epilogue", 7000, 800),
]
SPAN_ON_DEVICE = Event("fse.enhance", 4600, 3300, CUDA, annotation=True)
EVENTS = DEVICE + HOST + SPANS + [SPAN_ON_DEVICE]


def test_reduce_gives_the_hand_computed_slice():
    got = trace.reduce(EVENTS)
    assert set(got) == {"window_s", "busy_s", "kernels", "copies", "idle_by_host"}
    assert got["window_s"] == pytest.approx(10000e-9, rel=1e-12)
    assert got["busy_s"] == pytest.approx(4700e-9, rel=1e-12)
    assert got["kernels"] == {"early_kernel": [pytest.approx(200e-9), 1],
                              STACK: [pytest.approx(2000e-9), 1],
                              "elementwise_kernel": [pytest.approx(1000e-9), 1],
                              "late_kernel": [pytest.approx(500e-9), 1]}
    assert got["copies"] == {HTOD: [pytest.approx(500e-9), 1], DTOH: [pytest.approx(1000e-9), 1]}
    # each gap by the innermost host event over its middle (1350, 6250, 9750):
    # a span is named where it is that event
    assert got["idle_by_host"] == {"cudaMemcpyAsync": pytest.approx(300e-9),
                                   "fse.enhance.model": pytest.approx(3500e-9),
                                   trace.NO_OP: pytest.approx(1500e-9)}


def test_the_spans_split_the_idle_time_exactly_once():
    summary, split = trace.reduce(EVENTS), spans.reduce(EVENTS)
    table = split["spans"]
    assert set(table) == {"fse.upload", "fse.enhance", "fse.enhance.prologue",
                          "fse.enhance.model", "fse.enhance.epilogue"}
    # idle: the upload's gap; enhance's own 100 + 100 ns around its children;
    # the caller's 100 + 100 ns around the call and the whole last gap
    want = {"fse.upload": 300, "fse.enhance": 200, "fse.enhance.prologue": 300,
            "fse.enhance.model": 2000, "fse.enhance.epilogue": 800}
    assert {k: v[3] for k, v in table.items()} == {
        k: pytest.approx(v * 1e-9) for k, v in want.items()}
    assert split["idle_outside_spans_s"] == pytest.approx(1700e-9)
    idle = sum(v[3] for v in table.values()) + split["idle_outside_spans_s"]
    assert idle == pytest.approx(summary["window_s"] - summary["busy_s"], rel=1e-12)


def test_span_counts_and_host_seconds_are_clipped_to_the_slice():
    table = spans.reduce(EVENTS)["spans"]
    assert table["fse.enhance"][:2] == [pytest.approx((50 + 3300) * 1e-9), 2]
    assert table["fse.upload"][:2] == [pytest.approx(400e-9), 1]
    assert table["fse.enhance.model"][:2] == [pytest.approx(2000e-9), 1]


def test_self_time_leaves_out_the_children():
    table = spans.reduce(EVENTS)["spans"]
    assert table["fse.enhance"][2] == pytest.approx((50 + 3300 - 300 - 2000 - 800) * 1e-9)
    for leaf in ("fse.upload", "fse.enhance.prologue", "fse.enhance.model"):
        assert table[leaf][2] == pytest.approx(table[leaf][0])


def test_a_device_side_span_annotation_adds_no_busy_time():
    without = [e for e in EVENTS if e is not SPAN_ON_DEVICE]
    assert trace.reduce(EVENTS) == trace.reduce(without)
    assert spans.reduce(EVENTS) == spans.reduce(without)


def test_the_spans_move_no_device_metric():
    """Every per-layer metric of the accepted benchmark reads the same slice
    with the program's spans in it as without."""
    bench = manifest.load()
    config = manifest.config("pix_shuffle")
    bare = trace.reduce(DEVICE + HOST)
    marked = trace.reduce(EVENTS)
    for key in ("window_s", "busy_s", "kernels", "copies"):
        assert marked[key] == bare[key]
    for m in bench["per_layer"]:
        read = manifest.reader(m["name"])
        values = [read(dict(trace=dict(t, frames=2), config=config, cuda=True))
                  for t in (bare, marked)]
        assert values[0] == values[1], m["name"]


def test_the_readings_add_up_to_the_idle_share():
    summary, split = trace.reduce(EVENTS), spans.reduce(EVENTS)
    got = spans.readings(summary, split, frames=2)
    assert got["upload_host_ms"] == pytest.approx(1e3 * 400e-9 / 2)
    assert got["launch_host_ms"] == pytest.approx(1e3 * 3350e-9 / 2)
    assert got["idle_in_program_pct"] == pytest.approx(100 * 3600 / 10000)
    assert got["idle_in_program_pct"] + got["idle_caller_pct"] == pytest.approx(
        got["device_idle_pct"], abs=1e-9)
    none = spans.readings(trace.reduce(DEVICE + HOST), spans.reduce(DEVICE + HOST), frames=2)
    assert none["upload_host_ms"] is none["launch_host_ms"] is none["idle_in_program_pct"] is None


def test_a_cpu_rehearsal_counts_one_enhance_and_one_upload_a_call(capsys):
    from port_bench.tools import span_split

    assert span_split.main(["--workload", "pix_shuffle.offline_b1", "--seed", str(2**31 + 17),
                            "--seconds", "1.2", "--device", "cpu", "--frame", "48x80"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    calls, table = line["calls_traced"], line["spans"]
    assert calls > 0 and line["device"] == "cpu" and line["idle_in_program_pct"] is None
    assert abs(table["fse.enhance"][1] - calls) <= 1
    assert abs(table["fse.upload"][1] - calls) <= 1
    for child in ("fse.enhance.prologue", "fse.enhance.model", "fse.enhance.epilogue"):
        assert abs(table[child][1] - calls) <= 1
    idle = sum(v[3] for v in table.values()) + line["idle_outside_spans_s"]
    assert idle == pytest.approx(line["window_s"] - line["busy_s"], rel=1e-9)
