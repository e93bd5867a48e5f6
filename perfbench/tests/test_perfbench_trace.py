"""The reduction of the profiler's traces, and the loops found by name."""
import pytest

from perfbench import devtrace, loops


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, **kw}


def test_device_time_is_the_union_of_device_operations():
    events = [_x("kernel", "B", 0.0, 100.0), _x("kernel", "C", 50.0, 100.0),
              _x("gpu_memset", "set", 300.0, 10.0),
              _x("cpu_op", "aten::mm", 0.0, 1000.0),
              {"ph": "i", "cat": "kernel", "name": "mark", "ts": 5.0}]
    got = devtrace.device_time(events)
    assert got["busy_s"] == pytest.approx(160e-6)
    assert got["device_ops"] == [["B", pytest.approx(100e-6)],
                                 ["C", pytest.approx(100e-6)],
                                 ["set", pytest.approx(10e-6)]]


def test_a_trace_without_device_operations_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.device_time([_x("cpu_op", "aten::mm", 0.0, 10.0)])


def test_idle_gaps_are_named_by_the_hosts_innermost_span_and_op():
    events = [_x("user_annotation", devtrace.WINDOW, 0.0, 1000.0),
              _x("user_annotation", "perfbench.fit", 0.0, 600.0),
              _x("cpu_op", "aten::sum", 100.0, 200.0),
              _x("kernel", "B", 300.0, 200.0, pid=0, tid=7),
              _x("cpu_op", "aten::item", 650.0, 300.0)]
    got = dict((name, sec) for name, sec in devtrace.idle_gaps(events))
    assert got == {"perfbench.fit > aten::sum": pytest.approx(300e-6),
                   "perfbench > aten::item": pytest.approx(500e-6)}


@pytest.mark.parametrize("name", ["fit_evaluate", "evaluate"])
def test_a_mix_finds_its_loop_by_name(name):
    cls = loops.find(name)
    assert cls.__module__ == f"perfbench.loops.{name}"
    assert issubclass(cls, loops.BaseLoop)


@pytest.mark.parametrize("name", ["../run", "fit.evaluate", "Evaluate", ""])
def test_a_loop_name_is_a_module_name(name):
    with pytest.raises(ValueError):
        loops.find(name)
