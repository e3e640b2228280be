"""Reading a device trace: the marker aligns the profiler's clock to the
host's, what runs after the window's close is cut off, and the idle share
is read alike for every cell."""

import json
from types import SimpleNamespace

import pytest

from portbench import common
from portbench.trace import DeviceTrace


def _event(name, start_s, end_s, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": start_s * 1e6, "dur": (end_s - start_s) * 1e6}


def _trace(events, t_start=5.0, t_end=9.0):
    dt = DeviceTrace(True, "cpu")

    def export_chrome_trace(path):
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    dt._prof = SimpleNamespace(export_chrome_trace=export_chrome_trace)
    dt.t_start, dt.t_end = t_start, t_end
    dt.read()
    return dt


def test_the_window_is_aligned_and_cut_at_its_close():
    dt = _trace([
        _event("marker", 100.0, 100.001),
        _event("cudaLaunchKernel", 100.1, 100.2, cat="cuda_runtime"),
        _event("conv", 101.0, 102.0),
        _event("copy", 102.5, 103.0, cat="gpu_memcpy"),
        _event("late", 103.5, 104.5),  # runs past the close at host 9 s: cut there
        _event("after", 104.2, 104.3),  # starts after the close: left out
    ])
    assert [o[0] for o in dt.ops] == ["conv", "copy", "late"]
    assert dt.ops[0][2:] == pytest.approx((6.0, 7.0))
    assert dt.ops[-1][3] == pytest.approx(9.0)
    assert dt.window_s() == pytest.approx(3.0)  # opens with the program's first operation
    assert dt.busy_s() == pytest.approx(2.0)
    obs = {"trace": dt}
    engine, train = (common.load_metric(f"device_idle.{c}").read(obs) for c in ("engine", "train"))
    assert engine == train == pytest.approx(100.0 / 3)


def test_an_empty_trace_gives_no_idle_share():
    dt = _trace([_event("marker", 100.0, 100.001)])
    assert dt.ops == [] and common.load_metric("device_idle.engine").read({"trace": dt}) is None


def test_what_ran_before_the_window_opened_is_cut_off():
    dt = DeviceTrace(True, "cpu")
    events = [_event("marker", 100.0, 100.001), _event("filling", 100.5, 101.0),
              _event("across", 101.5, 102.5), _event("steady", 103.0, 104.0)]

    def export_chrome_trace(path):
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    dt._prof = SimpleNamespace(export_chrome_trace=export_chrome_trace)
    dt.t_start, dt.t_open, dt.t_end = 5.0, 7.0, 9.0
    dt.read()
    assert [o[0] for o in dt.ops] == ["across", "steady"]
    assert dt.ops[0][2:] == pytest.approx((7.0, 7.5))
    assert dt.window_s() == pytest.approx(2.0) and dt.busy_s() == pytest.approx(1.5)
