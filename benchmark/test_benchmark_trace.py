"""The reading of a traced window (``benchmark/trace.py``) on a made-up
Chrome trace whose answers are known: two calls, each a kernel launched
under ``hs.kernel`` and a reduce op launched under ``hs.reduce``."""

from __future__ import annotations

import pytest

from benchmark.trace import TracedWindow


def _span(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _call(t0: float, corr: int) -> list:
    """A call of 100 us at ``t0``: set-up to +8, its budget call +8..+60
    with the launch at +9 under ``hs.kernel``, the kernel +10..+60 on the
    device, the reduce +62..+90 with an op +70..+80, the result to +100."""
    return [
        _span("user_annotation", "bench.call", t0, 100),
        _span("user_annotation", "hs.macro_block", t0 + 8, 52),
        _span("user_annotation", "hs.kernel", t0 + 8.5, 1),
        _span("cuda_runtime", "cudaLaunchKernel", t0 + 9, 0.5, correlation=corr),
        _span("kernel", "event_step_kernel", t0 + 10, 50, correlation=corr),
        _span("user_annotation", "hs.reduce", t0 + 62, 28),
        _span("cuda_runtime", "cudaLaunchKernel", t0 + 63, 0.5, correlation=corr + 1),
        _span("kernel", "reduce_kernel", t0 + 70, 10, correlation=corr + 1),
    ]


@pytest.fixture
def window():
    return TracedWindow(_call(0.0, 1) + _call(110.0, 3))


def test_busy_idle_and_the_ranges(window):
    assert window.window_us == 210
    assert window.busy_us == 120
    assert window.device_us_under("hs.kernel") == 100
    assert window.device_us_under("hs.reduce") == 20
    assert window.host_exposed_us() == [40, 40]
    assert window.top_device_ops(1) == [["event_step_kernel", 100e-6]]


def test_each_idle_moment_goes_to_one_host_phase(window):
    phases = window.idle_by_host_phase()
    assert phases["hs.kernel"] == pytest.approx(2 * 1e-6)
    assert phases["hs.macro_block outside hs.kernel"] == pytest.approx(2 * 1e-6)
    assert phases["hs.reduce"] == pytest.approx(2 * 18e-6)
    assert phases["engine set-up before hs.macro_block"] == pytest.approx(2 * 8e-6)
    assert phases["result after hs.reduce"] == pytest.approx(2 * 10e-6)
    assert phases["rest of bench.call"] == pytest.approx(2 * 2e-6)
    assert phases["between calls"] == pytest.approx(10e-6)
    assert sum(phases.values()) == pytest.approx((window.window_us - window.busy_us) / 1e6)
