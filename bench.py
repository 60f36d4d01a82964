"""Headline benchmark: CG iterations/s on the implicit RBF kernel-matvec.

Prints ONE JSON line whose headline keys are stable across rounds:
``{"metric": ..., "value": N, "unit": "iters/s", "vs_baseline": N, ...}``.
The same line also carries the mode-breadth and roofline survey under
``"modes"`` / ``"roofline"``:

- per-mode CG iters/s for every execution strategy the framework ships
  (implicit, cached-K GEMV, linear two-GEMM, streaming sparse),
- the roofline position of the two hot modes: achieved FLOP/s of the
  implicit Gram products against the card's peak at the dot tier they ran
  (exact f32 or TF32), and achieved memory bandwidth of the cached-K GEMV
  against the card's peak.

Measures the flagship configuration from BASELINE.json: RBF-kernel LS-SVM
CG where the implicit kernel matrix is never materialized
(``ops/matvec.py`` mode='implicit').  Timing excludes compilation (warmup
run first); the loop runs a fixed iteration count (eps=0 disables the
convergence stop).  The bench measures a GPU only: on any other platform,
or on a card missing from :data:`PEAKS`, it exits with an error, and a
phase that fails ends the run with a non-zero exit code.

Baselines, strongest first:

- ``reference_binary`` / ``vs_reference_binary`` — the REFERENCE'S OWN
  ``plssvm-train`` (OpenMP backend, built by
  ``scripts/build_reference_cpu.sh``), trained live on the same
  data/kernel on this host; emitted whenever the binary is present.
- ``ours_cpu_same_host`` — this framework on the identical CPU cores
  (XLA-CPU, cached-K), isolating the algorithmic win from the GPU win.
- ``vs_baseline`` — a numpy f64 implementation of the reference's
  per-iteration algorithm (kept for cross-round metric continuity).

``sparse_tiers`` (on by default) reproduces the big-sparse three-tier
table at 16384x4096 @1% through the product surface, slope-timed over
executed CG iterations with a run-to-run noise guard.

Environment knobs: PLSSVM_BENCH_N (default 4096), PLSSVM_BENCH_F (256),
PLSSVM_BENCH_ITERS (256), PLSSVM_BENCH_MODE (implicit),
PLSSVM_BENCH_MODES=0 to skip the per-mode survey (headline only),
PLSSVM_BENCH_SPARSE=0 to skip the tier table
(PLSSVM_BENCH_SPARSE_N/F/DENSITY size it).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

#: Published peaks per card, keyed by ``jax.devices()[0].device_kind``:
#: dense tensor-core bf16 and TF32, float32 outside the tensor cores
#: (TFLOP/s), and memory bandwidth (GB/s).  Source: NVIDIA H100 Tensor Core
#: GPU data sheet, SXM part, without sparsity, at its 700 W limit; a card
#: set below that limit (``nvidia-smi --query-gpu=power.limit``) cannot
#: hold these rates, so results carry the limit beside them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, tf32_tflops=495.0,
                                  fp32_tflops=67.0, hbm_gbs=3350.0),
}


def device_peaks(kind: str) -> dict:
    """The :data:`PEAKS` row of a card; a card not in the table is an error."""
    if kind not in PEAKS:
        raise SystemExit(f"bench: no published peaks for device kind '{kind}' "
                         f"(known: {sorted(PEAKS)})")
    return PEAKS[kind]


def power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    import subprocess

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _slope_rate(run, lo, hi, trials=5, grow_to_seconds=None):
    """Two-point-slope iterations/s — see ``utils.timing.slope_rate``."""
    from plssvm_sparse_fp22.utils.timing import slope_rate

    return slope_rate(run, lo, hi, trials=trials,
                      grow_to_seconds=grow_to_seconds)


def _make_dense_runner(X, gamma, kernel_name, mode):
    import jax
    import jax.numpy as jnp
    from plssvm_sparse_fp22.models.base import _learn_jit
    from plssvm_sparse_fp22.ops.matvec import resolve_precision_plan
    from plssvm_sparse_fp22.types import KernelType

    n, f = X.shape
    dept = n - 1
    block = 256
    D = _round_up(dept, block)
    dtype = np.float32

    X_pad = np.zeros((D, f), dtype=dtype)
    X_pad[:dept] = X[:dept]
    mask = np.zeros(D, dtype=dtype)
    mask[:dept] = 1.0

    # the product's precision plan (fixed tier unless
    # PLSSVM_MATMUL_PRECISION=adaptive; eps=0 then pins every iteration to
    # the fast tier)
    kw = dict(kernel=KernelType.from_string(kernel_name), degree=3, mode=mode,
              precision_plan=resolve_precision_plan(mode, dtype))
    X_dev = jnp.asarray(X_pad)
    xl_dev = jnp.asarray(X[-1].astype(dtype))
    mask_dev = jnp.asarray(mask)

    def run(seed, n_iters):
        rng = np.random.default_rng(seed)
        b_pad = np.zeros(D, dtype=dtype)
        b_pad[:dept] = np.where(rng.normal(size=dept) > 0, 2.0, -2.0)
        args = (
            X_dev, xl_dev, jnp.asarray(b_pad), mask_dev,
            jnp.asarray(gamma, dtype), jnp.asarray(0.0, dtype),
            jnp.asarray(1.0, dtype),
            jnp.asarray(0.0, dtype),   # eps = 0 -> fixed iteration count
            jnp.asarray(n_iters, jnp.int32),
        )
        t0 = time.perf_counter()
        out = _learn_jit(*args, **kw)
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - t0
        # (elapsed, executed): slope_rate divides by executed iterations —
        # exact even if the eps=0 CG hits a float-exact zero residual early
        return elapsed, int(out[4])

    return run, D


def _make_sparse_runner(n, f, density, gamma):
    """Streaming sparse implicit rbf (the fork's north star, BASELINE.json
    config 3): CG over the tiled-ELL packing with the scatter-free panel
    strategy — no (n, n) Gram, no resident densified X (kernel blocks
    recomputed per iteration from transient panels)."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from plssvm_sparse_fp22.models.sparse_learn import learn_sparse_panel_jit
    from plssvm_sparse_fp22.ops.sparse import TiledELL, stream_panel_rows
    from plssvm_sparse_fp22.types import KernelType

    rng = np.random.default_rng(7)
    csr = sp.random(n, f, density=density, format="csr", dtype=np.float32,
                    random_state=rng)
    dept = n - 1
    D = _round_up(dept, 256)
    dtype = np.float32
    tell = TiledELL.from_csr(csr[:dept], dtype=dtype, pad_rows=D)
    # a deliberately sub-dense budget keeps the panel decomposition honest
    # (several panels even when dense X would fit HBM)
    budget = int(os.environ.get("PLSSVM_K_CACHE_BYTES",
                                D * tell.padded_features))
    panel_rows = stream_panel_rows(D, tell.padded_features, 4, budget)
    x_last = np.asarray(csr[-1].todense()).ravel().astype(dtype)
    mask = np.zeros(D, dtype=dtype)
    mask[:dept] = 1.0
    mask_dev = jnp.asarray(mask)
    xl_dev = jnp.asarray(x_last)

    def run(seed, n_iters):
        r = np.random.default_rng(seed)
        b_pad = np.zeros(D, dtype=dtype)
        b_pad[:dept] = np.where(r.normal(size=dept) > 0, 2.0, -2.0)
        t0 = time.perf_counter()
        out = learn_sparse_panel_jit(
            tell.vals, tell.lcols, xl_dev, jnp.asarray(b_pad), mask_dev,
            jnp.asarray(gamma, dtype), jnp.asarray(0.0, dtype),
            jnp.asarray(1.0, dtype), jnp.asarray(0.0, dtype),
            jnp.asarray(n_iters, jnp.int32),
            kernel=KernelType.rbf, degree=3, ntiles=tell.ntiles, Lt=tell.Lt,
            panel_rows=panel_rows,
        )
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - t0
        return elapsed, int(out[4])

    return run


def _sparse_tier_bench(n, f, density):
    """The big-sparse regression block: end-to-end warm
    learn time plus the slope-timed marginal cost per EXECUTED CG
    iteration for each sparse poly/rbf tier at the configured size,
    through the product surface (the PERF.md three-tier table, reproduced
    every round).  On by default (PLSSVM_BENCH_SPARSE=0 skips; size knobs
    PLSSVM_BENCH_SPARSE_N/F/DENSITY, default 16384x4096 @ 1%)."""
    import scipy.sparse as sp
    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models import make_csvm
    from plssvm_sparse_fp22.params import Parameter
    from plssvm_sparse_fp22.types import KernelType

    rng = np.random.default_rng(3)
    csr = sp.random(n, f, density=density, format="csr", dtype=np.float32,
                    random_state=rng)
    # labels perturbed off the +-1 lattice AND gamma scaled so the kernel
    # matrix is not near-rank-one: at gamma = 1/f with ~1% uniform data,
    # exp(-gamma d^2) ~ 0.99 everywhere and the eps=0 CG hits an exact-zero
    # f32 residual at ~23 iterations, capping every measurement span below
    # the fast tiers' noise floor.  gamma = 256/f puts the
    # off-diagonals at ~0.2 — a well-conditioned system that sustains the
    # iteration counts the slope needs.  Sign semantics are unchanged.
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0) * (
        1.0 + 0.01 * rng.random(n))

    def learn_once(iters):
        params = Parameter(kernel=KernelType.rbf, gamma=256.0 / f, cost=1.0,
                           epsilon=0.0, max_iter=iters, print_info=False,
                           dtype=np.float32, sparse_threshold=1.0, devices=1)
        params.data = ParsedData(csr=csr, values=y)
        params.values = y
        svm = make_csvm(params)
        t0 = time.perf_counter()
        svm.learn()
        return time.perf_counter() - t0, svm

    tiers = {}
    prior_mode = os.environ.get("PLSSVM_SPARSE_MODE")
    for tier in ("gram", "dense", "implicit"):
        os.environ["PLSSVM_SPARSE_MODE"] = tier
        try:
            lo, hi = 8, 108
            learn_once(lo)  # compile warmup
            learn_once(hi)

            def sample(iters, reps=3):
                """(min_time, noise, svm): min over reps is robust to
                one-sided latency spikes (host pack + ~1 GB device
                transfer per learn can fluctuate by seconds); noise = gap
                between the two smallest samples."""
                times, svm = [], None
                for _ in range(reps):
                    t, svm = learn_once(iters)
                    times.append(t)
                times.sort()
                return times[0], times[1] - times[0], svm

            t_lo, n_lo, svm_lo = sample(lo)
            # grow the span until it dwarfs the measured run-to-run noise
            # (a span inside the noise floor used to null every tier;
            # the iteration cap is a dynamic argument, so
            # growth costs no recompiles), capped so one tier cannot eat
            # the bench's budget
            per_iter, it_lo, it_hi = None, None, None
            while True:
                t_hi, n_hi, svm = sample(hi)
                it_lo = int(svm_lo.last_cg_info["iterations"])
                it_hi = int(svm.last_cg_info["iterations"])
                span = t_hi - t_lo
                if it_hi > it_lo and span > 2.0 * (n_lo + n_hi):
                    # marginal cost over EXECUTED iterations (the eps=0 CG
                    # can stop early on an exact-zero f32 residual); the
                    # slope cancels the one-time host pack/transfer/setup
                    per_iter = round(span / (it_hi - it_lo), 5)
                    break
                if hi >= 2048 or it_hi == it_lo or t_hi > 120.0:
                    break  # converged-early or budget cap: honest null
                hi *= 3
            tiers[f"sparse_{tier}"] = {
                "learn8_s": round(t_lo, 4),
                "s_per_iter": per_iter,
                "iters": [it_lo, it_hi],
                "mode": svm.last_cg_info["mode"],
            }
        finally:
            if prior_mode is None:
                os.environ.pop("PLSSVM_SPARSE_MODE", None)
            else:
                os.environ["PLSSVM_SPARSE_MODE"] = prior_mode
    return tiers


def _time_to_tolerance(n, f):
    """The literal BASELINE.json metric: wall time for a full `learn()` to
    the 1e-6 CG tolerance on a separable two-blob dataset, through the
    product surface (make_csvm), plus training accuracy."""
    import scipy.sparse as sp
    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models import make_csvm
    from plssvm_sparse_fp22.params import Parameter
    from plssvm_sparse_fp22.types import KernelType

    rng = np.random.default_rng(11)
    half = n // 2
    X = np.vstack([rng.normal(-0.4, 1.0, size=(half, f)),
                   rng.normal(0.4, 1.0, size=(n - half, f))]).astype(np.float32)
    y = np.concatenate([-np.ones(half), np.ones(n - half)])
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]

    def fresh():
        params = Parameter(kernel=KernelType.rbf, gamma=1.0 / f, cost=1.0,
                           epsilon=1e-6, print_info=False, dtype=np.float32)
        params.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        params.values = y
        return make_csvm(params)

    fresh().learn()  # compile warmup
    svm = fresh()
    t0 = time.perf_counter()
    svm.learn()
    seconds = time.perf_counter() - t0
    out = {
        "seconds": round(seconds, 4),
        "iterations": svm.last_cg_info["iterations"],
        "converged": svm.last_cg_info["delta"]
        <= 1e-12 * svm.last_cg_info["delta0"],
        "mode": svm.last_cg_info["mode"],
        "train_accuracy_pct": round(100.0 * svm.accuracy(), 2),
    }
    if "fast_iterations" in svm.last_cg_info:
        # adaptive two-tier CG: how many iterations the fast tier carried
        out["fast_iterations"] = svm.last_cg_info["fast_iterations"]
        out["escalated"] = svm.last_cg_info["escalated"]
    return out


def _adaptive_escalation(n, f):
    """The adaptive-precision safety net, demonstrated end-to-end: an
    ill-conditioned fixture (overlapping blobs, cost=1e3 -> weak 1e-3
    diagonal regularization on a fast-decaying RBF spectrum) whose
    fast-tier solution should miss the 1e-6 tolerance, so the
    accurate-tier residual check fires and CG re-enters on the accurate
    tier — and must still converge.  On well-conditioned data the same
    machinery never leaves the fast tier (see
    ``time_to_tolerance_1e6.fast_iterations``).  The plan runs only under
    ``PLSSVM_MATMUL_PRECISION=adaptive`` (``ops/matvec.resolve_precision_plan``)."""
    import scipy.sparse as sp
    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models import make_csvm
    from plssvm_sparse_fp22.params import Parameter
    from plssvm_sparse_fp22.types import KernelType

    rng = np.random.default_rng(11)
    half = n // 2
    X = np.vstack([rng.normal(-0.05, 1.0, size=(half, f)),
                   rng.normal(0.05, 1.0, size=(n - half, f))]).astype(np.float32)
    y = np.concatenate([-np.ones(half), np.ones(n - half)])
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]
    eps = 1e-6
    params = Parameter(kernel=KernelType.rbf, gamma=0.25 / f, cost=1e3,
                       epsilon=eps, print_info=False, dtype=np.float32,
                       devices=1)
    params.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    params.values = y
    svm = make_csvm(params)
    svm.learn()
    info = svm.last_cg_info
    return {
        "iterations": info["iterations"],
        "fast_iterations": info.get("fast_iterations"),
        "escalated": info.get("escalated"),
        "converged": info["delta"] <= eps ** 2 * info["delta0"],
        "train_accuracy_pct": round(100.0 * svm.accuracy(), 2),
    }


#: peak key of each dot tier for an f32 Gram product on the card
_TIER_PEAK = {"highest": "fp32_tflops", "high": "tf32_tflops",
              "default": "tf32_tflops"}


def _implicit_roofline(D, dept, f, iters_per_s, peaks, tier="highest"):
    """Roofline position of the implicit Gram matvec: one full
    (non-triangular) ``2*D^2*f`` FLOP product per iteration at the dot
    tier it ran, against that tier's peak, plus the useful-FLOP rate
    ``2*dept^2*f`` (one exact Gram matvec on the real rows)."""
    hw_flops = 2 * D * D * f
    useful_flops = 2 * dept ** 2 * f
    out = {
        "dot_tier": tier,
        "hw_tflops": hw_flops * iters_per_s / 1e12,
        "useful_tflops": useful_flops * iters_per_s / 1e12,
    }
    peak = peaks[_TIER_PEAK[tier]]
    out["peak_frac"] = out["hw_tflops"] / peak
    out["useful_frac"] = out["useful_tflops"] / peak
    return out


def _cached_roofline(D, iters_per_s, peak_gbs):
    """The cached-K GEMV reads the (D, D) f32 kernel slab once per
    iteration — pure memory-bandwidth roofline (BASELINE.md)."""
    bytes_per_iter = D * D * 4
    out = {"hbm_gbs": bytes_per_iter * iters_per_s / 1e9}
    if peak_gbs:
        out["hbm_peak_frac"] = out["hbm_gbs"] / peak_gbs
    return out


def _bench_reference_binary(X, y, gamma):
    """CG iterations/s of the ACTUAL reference implementation (its OpenMP
    backend, built by scripts/build_reference_cpu.sh against the interop
    shims) on this host — the honest reference comparable, measured live.
    Returns None when the binary isn't available (e.g. CI)."""
    import re
    import subprocess
    import tempfile

    train_bin = os.path.join(
        os.environ.get("PLSSVM_REFERENCE_BUILD", "/tmp/refbuild"),
        "plssvm-train")
    if not os.path.exists(train_bin):
        return None
    n, f = X.shape
    with tempfile.TemporaryDirectory() as td:
        data = os.path.join(td, "bench.libsvm")
        with open(data, "w") as fh:
            for xi, yi in zip(X, y):
                feats = " ".join(f"{j + 1}:{v:.7g}" for j, v in enumerate(xi))
                fh.write(f"{int(yi)} {feats}\n")
        try:
            # 1e-6 tolerance: a few more CG iterations than the 1e-3
            # default, for a less noisy per-iteration rate
            res = subprocess.run(
                [train_bin, "-t", "2", "-g", str(gamma), "-e", "0.000001",
                 data, os.path.join(td, "bench.model")],
                capture_output=True, text=True, timeout=1800)
        except subprocess.TimeoutExpired:
            return None
    m_it = re.search(r"Finished after (\d+) iterations", res.stdout)
    m_ms = re.search(r"using CG in (\d+)ms", res.stdout)
    if not (m_it and m_ms):
        return None
    ms = max(1, int(m_ms.group(1)))
    return {"iters_per_s": round(int(m_it.group(1)) / (ms / 1000.0), 4),
            "iterations": int(m_it.group(1)),
            "cg_seconds": ms / 1000.0,
            "what": ("the reference's own plssvm-train (OpenMP backend, "
                     f"f64) on this host's {os.cpu_count()} CPU cores, "
                     "same data/kernel, 1e-6 tolerance")}


def _bench_our_cpu(n, f, gamma):
    """Our own CG iterations/s on THIS HOST'S CPU (XLA-CPU backend, f64,
    auto mode) — the same-hardware comparison against the reference
    binary: both run on the identical cores, isolating the algorithmic
    win (cached-K GEMV vs the reference recomputing the O(n^2 f) kernel
    product every iteration).  Subprocess because the parent holds the
    GPU."""
    import subprocess
    import sys

    code = f"""
import jax; jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
import sys, time, json
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import numpy as np, bench
rng = np.random.default_rng(42)
X = rng.normal(size=({n}, {f})).astype(np.float32)
run, _D = bench._make_dense_runner(X, {gamma}, "rbf", "cached")
rate = bench._slope_rate(run, 16, 64, trials=3)
print("RATE " + json.dumps(rate))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, check=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    line = next(l for l in res.stdout.splitlines() if l.startswith("RATE "))
    return {"iters_per_s": round(float(line[5:]), 3),
            "what": ("this framework on the SAME host CPU (XLA-CPU, "
                     "cached-K mode) — isolates the algorithmic win "
                     "from the hardware win")}


def _bench_numpy_baseline(X, gamma, iters):
    """The reference algorithm per CG iteration: full implicit kernel-matrix
    product, recomputed every iteration (no K caching), float64."""
    n, f = X.shape
    dept = n - 1
    Xd = X[:dept].astype(np.float64)
    sq = (Xd * Xd).sum(1)
    rng = np.random.default_rng(0)
    v = rng.normal(size=dept)
    q = rng.normal(size=dept)

    def matvec(v):
        G = Xd @ Xd.T
        K = np.exp(-gamma * np.maximum(sq[:, None] + sq[None, :] - 2.0 * G, 0.0))
        s = v.sum()
        t = q @ v
        return K @ v + 2.0 * s - s * q - t + v

    matvec(v)  # warmup caches
    reps = max(1, min(3, iters // 8))
    t0 = time.perf_counter()
    for _ in range(reps):
        v = matvec(v)
        v /= np.linalg.norm(v)
    elapsed = (time.perf_counter() - t0) / reps
    return 1.0 / elapsed


def main():
    from plssvm_sparse_fp22.utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()

    n = int(os.environ.get("PLSSVM_BENCH_N", 4096))
    f = int(os.environ.get("PLSSVM_BENCH_F", 256))
    iters = int(os.environ.get("PLSSVM_BENCH_ITERS", 256))
    mode = os.environ.get("PLSSVM_BENCH_MODE", "implicit")
    survey = os.environ.get("PLSSVM_BENCH_MODES", "1") not in ("0", "off")
    gamma = 1.0 / f

    rng = np.random.default_rng(42)
    X = rng.normal(size=(n, f)).astype(np.float32)

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: measures a GPU; JAX runs on "
                         f"'{jax.default_backend()}'")
    kind = jax.devices()[0].device_kind
    peaks = device_peaks(kind)

    lo, hi = max(4, iters // 4), iters
    run, D = _make_dense_runner(X, gamma, "rbf", mode)
    # grow the span until it dwarfs dispatch jitter
    value = _slope_rate(run, lo, hi, trials=7, grow_to_seconds=0.5)
    baseline = _bench_numpy_baseline(X, gamma, iters)
    y_bench = np.where(np.random.default_rng(1).normal(size=n) > 0, 1, -1)
    ref_binary = _bench_reference_binary(X, y_bench, gamma)

    result = {
        "metric": f"cg_iters_per_s_rbf_{n}x{f}_{mode}_{jax.default_backend()}",
        "value": round(value, 3),
        "unit": "iters/s",
        # primary comparable when available: the REFERENCE'S OWN binary,
        # measured live below (vs_reference_binary); vs_baseline keeps the
        # numpy-proxy for cross-round metric continuity
        "vs_baseline": round(value / baseline, 3),
        "baseline": {
            "iters_per_s": round(baseline, 3),
            "what": (
                "the reference's per-iteration algorithm (full implicit "
                f"kernel-matrix product, f64) in numpy/BLAS on this host's "
                f"{os.cpu_count()} CPU cores — NOT a measured GPU run; the "
                "reference publishes no numbers (BASELINE.md)"),
        },
        "device": {"platform": jax.devices()[0].platform, "kind": kind,
                   "count": jax.device_count(), "power": power_limit()},
    }
    if ref_binary is not None:
        # the strongest comparable: the reference's own binary, measured
        # live on this host (built by scripts/build_reference_cpu.sh)
        result["vs_reference_binary"] = round(
            value / ref_binary["iters_per_s"], 3)
        result["reference_binary"] = ref_binary
        ours_cpu = _bench_our_cpu(n, f, gamma)
        ours_cpu["vs_reference_binary_same_host"] = round(
            ours_cpu["iters_per_s"] / ref_binary["iters_per_s"], 3)
        result["ours_cpu_same_host"] = ours_cpu

    if survey:
        modes = {f"{mode}_rbf": round(value, 3)}
        lo2, hi2 = max(4, iters // 8), max(8, iters // 2)
        for name, kern, m in (("cached_rbf", "rbf", "cached"),
                              ("linear", "linear", "linear")):
            if name.startswith(mode):
                continue
            r, _ = _make_dense_runner(X, gamma, kern, m)
            # grow the span: the fast modes need far more iterations than
            # the headline before the measured span dwarfs dispatch noise
            modes[name] = round(
                _slope_rate(r, lo2, hi2, trials=3, grow_to_seconds=0.2), 3)
        sparse_run = _make_sparse_runner(n, 8 * f, 0.05, gamma)
        modes["sparse_stream_rbf"] = round(
            _slope_rate(sparse_run, lo2, hi2, trials=3), 3)
        result["modes"] = modes
        result["time_to_tolerance_1e6"] = _time_to_tolerance(n, f)
        # the adaptive tier's safety net: an ill-conditioned fixture that
        # should escalate and still converge to 1e-6
        result["adaptive_escalation"] = _adaptive_escalation(n, f)

        # on by default so every run records the big-sparse tier table;
        # PLSSVM_BENCH_SPARSE=0 skips it
        if os.environ.get("PLSSVM_BENCH_SPARSE", "1") not in ("0", "off"):
            result["sparse_tiers"] = _sparse_tier_bench(
                int(os.environ.get("PLSSVM_BENCH_SPARSE_N", 16384)),
                int(os.environ.get("PLSSVM_BENCH_SPARSE_F", 4096)),
                float(os.environ.get("PLSSVM_BENCH_SPARSE_DENSITY", 0.01)))

        roofline = {}
        if mode == "implicit":
            roofline["implicit"] = {
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in _implicit_roofline(D, n - 1, f, value,
                                               peaks).items()
            }
        if isinstance(modes.get("cached_rbf"), float):
            roofline["cached_gemv"] = {
                k: round(v, 4)
                for k, v in _cached_roofline(D, modes["cached_rbf"],
                                             peaks["hbm_gbs"]).items()
            }
        roofline["device_peaks"] = peaks
        result["roofline"] = roofline

    print(json.dumps(result))


if __name__ == "__main__":
    main()
