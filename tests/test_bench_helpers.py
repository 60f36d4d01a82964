"""Smoke coverage for the benchmark harness (bench.py).

These tests run the harness building blocks at tiny shapes on CPU — the
numbers themselves come only from a GPU run; this pins that the machinery
executes and returns the right shapes, and that the peak table refuses an
unknown card.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def test_dense_runner_and_slope():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 32)).astype(np.float32)
    run, D = bench._make_dense_runner(X, 1.0 / 32, "rbf", "cached")
    elapsed, executed = run(1, 8)
    assert elapsed > 0 and 1 <= executed <= 8
    rate = bench._slope_rate(run, 4, 16, trials=2)
    assert rate > 0


def test_implicit_roofline_tiers():
    # the dot tier picks the peak the achieved rate is divided by
    peaks = bench.PEAKS["NVIDIA H100 80GB HBM3"]
    r_exact = bench._implicit_roofline(4096, 4095, 256, 1000.0, peaks)
    r_tf32 = bench._implicit_roofline(4096, 4095, 256, 1000.0, peaks,
                                      tier="default")
    assert r_exact["dot_tier"] == "highest"
    assert r_exact["hw_tflops"] == pytest.approx(2 * 4096 ** 2 * 256 * 1e-9)
    assert r_exact["hw_tflops"] == pytest.approx(r_tf32["hw_tflops"])
    assert r_exact["peak_frac"] == pytest.approx(
        r_tf32["peak_frac"] * peaks["tf32_tflops"] / peaks["fp32_tflops"])
    assert r_exact["useful_tflops"] < r_exact["hw_tflops"]
    with pytest.raises(KeyError):
        bench._implicit_roofline(4096, 4095, 256, 1.0, peaks, tier="bogus")
    with pytest.raises(SystemExit):
        bench.device_peaks("cpu")


def test_cached_roofline():
    out = bench._cached_roofline(4096, 100.0, 3350.0)
    assert out["hbm_gbs"] == pytest.approx(4096 * 4096 * 4 * 100.0 / 1e9)
    assert 0 < out["hbm_peak_frac"] < 100


def test_numpy_baseline_runs():
    X = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    rate = bench._bench_numpy_baseline(X, 0.125, 8)
    assert rate > 0


def test_adaptive_escalation_fixture_shape():
    """The escalation probe must return the contract keys (tiny shapes —
    without PLSSVM_MATMUL_PRECISION=adaptive the plan resolves fixed, so
    escalated may be absent)."""
    out = bench._adaptive_escalation(96, 16)
    assert {"iterations", "converged", "train_accuracy_pct"} <= set(out)
    assert out["converged"] in (True, False)
