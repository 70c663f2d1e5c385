"""Unit test for the bench timing harness (bench.fori_slope_seconds).

The harness's job is to report the per-iteration device time of a chained
loop INDEPENDENT of fixed per-dispatch cost. Simulate a device with a virtual
clock: each loop_fn(n, carry) call costs `overhead + n * per_iter`, and
the slope estimate must recover per_iter exactly, whatever the overhead.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _run(monkeypatch, per_iter, overhead, jitter=0.0):
    clock = VirtualClock()
    calls = []
    rng = np.random.default_rng(0)

    def loop_fn(n, carry):
        calls.append(n)
        clock.now += overhead + n * per_iter
        if jitter:
            clock.now += float(rng.uniform(0, jitter))
        return np.float32(carry + n)

    monkeypatch.setattr(bench.time, "perf_counter", clock.perf_counter)
    dt = bench.fori_slope_seconds(loop_fn, np.float32(0.0), repeats=3)
    return dt, calls


def test_slope_cancels_fixed_overhead_exactly(monkeypatch):
    per_iter = 2.5e-3
    for overhead in (80e-6, 2.5e-3, 0.5):  # good window .. terrible window
        dt, _ = _run(monkeypatch, per_iter, overhead)
        assert abs(dt - per_iter) < 1e-12, (overhead, dt)


def test_slope_sizes_passes_to_target(monkeypatch):
    # fast step -> many iterations per pass (capped at 1000)
    dt, calls = _run(monkeypatch, per_iter=1e-4, overhead=1e-3)
    assert abs(dt - 1e-4) < 1e-12
    # sizing targets ~0.4s of device time -> hits the 1000-iteration cap
    assert max(calls) == 1000

    # slow step -> small minimum pass sizes still used
    dt, calls = _run(monkeypatch, per_iter=0.05, overhead=1e-3)
    assert abs(dt - 0.05) < 1e-12
    assert min(calls) >= 5


def test_slope_median_rejects_degraded_pass(monkeypatch):
    # jitter adds a random nonnegative slowdown per pass (a degraded rig
    # window); the slope error is bounded by jitter / (n_large - n_small),
    # far below the per-iteration time, and the median over valid samples
    # tightens it
    per_iter = 2e-3
    dt, _ = _run(monkeypatch, per_iter, overhead=1e-3, jitter=1e-3)
    assert abs(dt - per_iter) < 1e-4


def test_nonpositive_slopes_discarded_not_clamped(monkeypatch):
    # A multi-second spike landing on the SMALL
    # pass makes (t_large - t_small) negative; the old clamp-to-1e-9 fed
    # that into min() and recorded absurd figures (e.g. 8e9 FPS). Such
    # samples must be discarded and the harness must still recover
    # per_iter from the remaining clean passes.
    clock = VirtualClock()
    per_iter, overhead = 2e-3, 1e-3
    state = {"timed_pairs_seen": 0, "spiked": False}

    def loop_fn(n, carry):
        clock.now += overhead + n * per_iter
        # After warmup+sizing (first two calls), spike the first SMALL
        # pass of the timed section with a giant degraded-window stall.
        state["timed_pairs_seen"] += 1
        if state["timed_pairs_seen"] == 3 and not state["spiked"]:
            state["spiked"] = True
            clock.now += 30.0
        return np.float32(carry + n)

    monkeypatch.setattr(bench.time, "perf_counter", clock.perf_counter)
    dt = bench.fori_slope_seconds(loop_fn, np.float32(0.0), repeats=3)
    assert abs(dt - per_iter) < 1e-9
    assert dt > 1e-4  # never the clamp artifact


def test_all_passes_degraded_raises(monkeypatch):
    # If every sample is non-positive the harness must refuse to report
    # a number rather than fabricate one.
    clock = VirtualClock()
    state = {"calls": 0}

    def loop_fn(n, carry):
        state["calls"] += 1
        clock.now += 1e-3 + n * 2e-3
        if state["calls"] >= 3 and state["calls"] % 2 == 1:
            clock.now += 30.0  # stall every small pass
        return np.float32(carry + n)

    monkeypatch.setattr(bench.time, "perf_counter", clock.perf_counter)
    try:
        bench.fori_slope_seconds(loop_fn, np.float32(0.0), repeats=3)
    except RuntimeError as e:
        assert "no positive slope" in str(e)
    else:
        raise AssertionError("expected RuntimeError on all-degraded rig")


def test_peaks_known_for_h100():
    row = bench.utilization_row(989e12, 3.35e12, 1.0,
                                "NVIDIA H100 80GB HBM3")
    assert abs(row["mfu_pct"] - 100.0) < 1e-9
    assert abs(row["mem_pct_est"] - 100.0) < 1e-9


def test_unknown_device_gets_no_utilization():
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "H100"):
        row = bench.utilization_row(1e12, 1e9, 1.0, kind)
        assert "mfu_pct" not in row and "mem_pct_est" not in row
        assert row["achieved_tflops"] == 1.0


def test_bench_refuses_without_gpu():
    """No CPU fallback: main() stops before timing anything."""
    import jax

    if jax.default_backend() == "gpu":
        return
    try:
        bench.main()
    except SystemExit as e:
        assert "GPU" in str(e)
    else:
        raise AssertionError("bench.main() ran without a GPU")
