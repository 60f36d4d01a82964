"""Scoped timers and profiler integration.

JAX equivalent of the reference's inline ``std::chrono`` spans
(SURVEY.md §5: parse time ``parameter.cpp:168-175``, setup
``csvm.cpp:247-250``, per-CG-iteration ``gpu_csvm.cpp:234-241``, predict
``gpu_csvm.cpp:121-124``, model write ``csvm.cpp:197-203``) plus the modern
upgrade the reference lacks: ``jax.profiler`` trace capture for TensorBoard.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def scoped_timer(label: str, print_info: bool = True, sink=None):
    """Print ``{label} in {ms}ms.`` on exit (the reference's timing UX)."""
    start = time.perf_counter()
    yield
    elapsed_ms = (time.perf_counter() - start) * 1000.0
    if sink is not None:
        sink(label, elapsed_ms)
    if print_info:
        print(f"{label} in {elapsed_ms:.0f}ms.")


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Capture a ``jax.profiler`` trace when ``log_dir`` is set (view with
    TensorBoard); no-op otherwise."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def slope_rate(run, lo: int, hi: int, trials: int = 5,
               grow_to_seconds: float | None = None,
               max_hi: int = 4096) -> float:
    """Iterations/s via a two-point slope — the ONE timing estimator shared
    by ``bench.py`` and ``scripts/scaling_bench.py``.

    ``run(seed, n_iters) -> elapsed_seconds`` must execute the same traced
    program at two iteration caps with fresh inputs; the rate is
    ``(hi - lo) / (t_hi - t_lo)``.  This cancels constant dispatch, transfer
    and compile overhead.  The median over ``trials`` is robust against
    dispatch-latency outliers in either direction (a min would keep
    noise-deflated samples).

    With ``grow_to_seconds``, the (lo, hi) span is widened (hi *= 4, capped
    at ``max_hi``) until the measured difference dwarfs dispatch noise.

    ``run`` may also return ``(elapsed_seconds, executed_iters)``: the
    slope then uses the *executed* counts, which keeps the estimate correct
    when an eps=0 CG stops before the cap (a small system's f32 residual
    can underflow to exactly 0.0, ending the loop early).
    """
    def call(seed, n):
        out = run(seed, n)
        return out if isinstance(out, tuple) else (out, n)

    call(0, lo)  # compile both caps (same program: imax is traced)
    if grow_to_seconds is not None:
        while hi < max_hi:
            t_hi, k_hi = call(1, hi)
            t_lo, _ = call(2, lo)
            if t_hi - t_lo >= grow_to_seconds or k_hi < hi:
                break  # span large enough, or the solve converges early
            lo, hi = hi, hi * 4
            call(0, hi)  # warm any fresh dispatch path
    samples = []
    for trial in range(trials):
        # alternate the call order: a monotone drift in dispatch latency
        # then biases half the trials each way and the median stays honest
        if trial % 2:
            t_hi, k_hi = call(200 + trial, hi)
            t_lo, k_lo = call(100 + trial, lo)
        else:
            t_lo, k_lo = call(100 + trial, lo)
            t_hi, k_hi = call(200 + trial, hi)
        if t_hi > t_lo and k_hi > k_lo:
            samples.append((t_hi - t_lo) / (k_hi - k_lo))
    if not samples:
        t, k = call(300, hi)
        return k / t
    samples.sort()
    return 1.0 / samples[len(samples) // 2]


class Timings:
    """Accumulating sink: label -> [durations_ms] (observability hook)."""

    def __init__(self) -> None:
        self.records: dict[str, list[float]] = {}

    def __call__(self, label: str, elapsed_ms: float) -> None:
        self.records.setdefault(label, []).append(elapsed_ms)

    def summary(self) -> dict[str, float]:
        return {k: sum(v) for k, v in self.records.items()}
