"""The trace reduction on a hand-made chrome trace."""
import pytest

from portbench.trace import WINDOW, Trace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    _x("user_annotation", WINDOW, 0, 100),
    _x("cpu_op", "aten::mm", 5, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 6, 2),
    _x("cuda_runtime", "cudaGraphLaunch", 20, 3),
    _x("cuda_driver", "cuLaunchKernel", 30, 1),
    _x("cuda_runtime", "cudaStreamSynchronize", 60, 35),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 1, tid=2),
    _x("kernel", "void tc_gemm<float>(float const*)", 10, 20),
    _x("kernel", "nvjet_tst_128x64", 25, 15),
    _x("gpu_memcpy", "Memcpy DtoD", 50, 5),
    _x("kernel", "void ssd_chunk_state<float>()", 90, 20),
    _x("gpu_user_annotation", WINDOW, 10, 90),
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1},
]


def test_busy_overlap_and_launches():
    tr = Trace.from_events(EVENTS, calls=2)
    assert tr.window_s == pytest.approx(100e-6)
    # [10, 40) and [50, 55) and [90, 100) inside the window
    assert tr.busy_s() == pytest.approx(45e-6)
    assert tr.overlap_s() == pytest.approx(5e-6)
    assert tr.launches == 4
    assert tr.kernel_s(lambda n: "tc_gemm<" in n) == pytest.approx(20e-6)
    # the union: [10, 30) and [25, 40) overlap for 5 us
    assert tr.kernel_s(lambda n: n.startswith(("void tc", "nvjet"))) == \
        pytest.approx(30e-6)


def test_top_ops_and_idle_gaps():
    tr = Trace.from_events(EVENTS, calls=2)
    assert [n for n, _ in tr.top_ops(2)] == [
        "void tc_gemm<float>(float const*)",
        "void ssd_chunk_state<float>()"]
    gaps = dict(tr.idle_gaps())
    # [0, 10): inside aten::mm at 5; [40, 50) and [55, 90): python, sync
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["python"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)


def test_no_window_is_refused():
    with pytest.raises(ValueError):
        Trace.from_events(EVENTS[1:], calls=1)
