#!/usr/bin/env python3
"""Bring-up check: the training and prediction path, compiled for an
NVIDIA GPU, checked against the repo's references.

    python chip_smoke.py           # one GPU: kernel, oracle, cli, sparse
    python chip_smoke.py --four    # four GPUs: the multi-device learns only

One process, one JAX client: nothing here starts another process that
opens JAX (``nvidia-smi`` is the only child).  Each phase passes or ends
the run with a non-zero exit code; nothing is caught and continued.  The
last line of standard output is the JSON contract
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.  Data is made from ``--seed``.

Phases (one GPU):

1. kernel — the implicit Gram matvec (``ops/matvec.py``, XLA) against a
   plain ``jnp`` reference computed in f64 on the card, for every kernel at
   16384x256 and 16384x2000; its time and CG iterations/s; and what XLA
   makes of each dot precision;
2. oracle — ``make_csvm().learn()`` in every mode, dense and CSR-retained,
   against ``utils/oracle.py`` in f64;
3. cli — ``plssvm-generate-data``, ``plssvm-train`` and ``plssvm-predict``
   in-process at 65536x256 (implicit), 32768x256 (cached) and linear;
4. sparse — an rcv1.binary-shaped CSR (sparse_gram tier) and 16384x4096
   at 1 % (panel tier, unrolled and windowed sweeps), each against the
   dense XLA learn, in f64.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: golden-model tolerance of tests/test_golden.py (alphas and bias, f64)
GOLDEN = dict(rtol=1e-4, atol=1e-6)
#: CG tolerance of both sides of every f64 comparison.  The bias
#: (``y_last + QA_cost * sum(x) - q.x``) cancels terms hundreds of times
#: its size: at 5000x2000 linear, runs stopped at 1e-10 or 1e-11 kept
#: alphas within 1e-7 but moved a bias of -2.6e-4 by up to 1.8e-6, past
#: GOLDEN's atol; from 1e-12 on it agreed to 2e-8 (CPU runs against the
#: oracle, 87-89 iterations)
ORACLE_EPS = 1e-12
#: CG iteration cap of the f64 comparisons
MAX_ITER = 2000
#: exact-tier kernel tolerance: max error relative to max|Kv|
EXACT_TOL = 1e-5
#: TF32-tier tolerance: TF32 keeps 10 mantissa bits (unit roundoff
#: 2^-11 ~ 4.9e-4 per operand); the Gram entries sum f such products, and
#: poly's cube triples the relative error
TF32_TOL = 1e-2
#: held-out accuracy the CLI runs must reach (blobs_merged, minmax-scaled:
#: 100 % for rbf and linear at 4096x256 on the CPU, fixed before any GPU
#: run)
CLI_MIN_ACCURACY = 0.99

# Sizes (n, f[, density]).  2000 is the reference's stress-test width
# (BASELINE.md); 47236 x 0.16 % is rcv1.binary's shape.
KERNEL_SHAPES = ((16384, 256), (16384, 2000))
TIMING_SHAPES = ((65536, 256), (16384, 2000))
ORACLE_SHAPES = ((4096, 256), (5000, 2000))
ORACLE_TEST_POINTS = 256
CLI_SHAPE = (65536, 16384, 32768, 256)  # train, test, cached train, f
#: the panel cases pin the streaming tier.  A 1 GiB budget cuts 4096-row
#: panels, 10 pairs per matvec: the unrolled sweep.  A 64 MiB budget cuts
#: 256-row panels, 2080 pairs: past the traced-pair cap, the windowed sweep
SPARSE_PANEL = {"PLSSVM_SPARSE_MODE": "implicit"}
SPARSE_CASES = (("rcv1-shaped", 20242, 47236, 0.0016, {}, "sparse_gram"),
                ("panel unrolled", 16384, 4096, 0.01,
                 dict(SPARSE_PANEL, PLSSVM_K_CACHE_BYTES=1 << 30),
                 "sparse_implicit"),
                ("panel windowed", 16384, 4096, 0.01,
                 dict(SPARSE_PANEL, PLSSVM_K_CACHE_BYTES=64 << 20),
                 "sparse_implicit"))
FOUR_RING = (16384, 256)
#: (name, n, f, density, kernel, environment of the four-GPU learn, mode).
#: The one-GPU learn it is compared with runs under the default budget.
#: The sparse ring's 64 MiB budget keeps dense X (512 MiB) off the dense
#: sharded path and cuts each 4096-row shard into 16 panels of 256 rows:
#: 256 products per hop, past the traced-pair cap, so the hop is scanned.
FOUR_CASES = (("row cached", 8192, 256, None, "rbf", {}, "sharded_cached[4]"),
              ("row implicit (ring)", 16384, 256, None, "rbf",
               {"PLSSVM_K_CACHE_BYTES": 1}, "sharded_implicit[4]"),
              ("feature", 600, 8192, None, "rbf", {}, "sharded_feature[4]"),
              ("sparse linear", 16384, 4096, 0.01, "linear", {},
               "sharded_sparse_linear[4]"),
              ("sparse ring", 16384, 4096, 0.01, "rbf",
               {"PLSSVM_K_CACHE_BYTES": 64 << 20}, "sharded_sparse_implicit[4]"))


T0 = time.perf_counter()


def log(*args):
    """Print with the seconds since start (compile time shows as gaps)."""
    print(f"[{time.perf_counter() - T0:7.1f}s]", *args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL {msg}")


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@contextlib.contextmanager
def env(**kw):
    """Set environment variables for a block (``None`` unsets)."""
    old = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def best_time(fn, X, v0, reps=10, rounds=3):
    """Seconds per call of ``fn(X, v)``, after warm-up, best of ``rounds``;
    each call feeds the (normalized) previous output back so no call is
    skipped, and the clock stops at ``block_until_ready``.  ``X`` is an
    argument of the compiled step, not a constant folded into it."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(X, v):
        y = fn(X, v)
        return y / jnp.linalg.norm(y)

    jax.block_until_ready(step(X, v0))
    best = float("inf")
    for _ in range(rounds):
        v = v0
        t0 = time.perf_counter()
        for _ in range(reps):
            v = step(X, v)
        jax.block_until_ready(v)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


# ---------------------------------------------------------------- data

def dense_data(n, f, seed):
    """blobs_merged, min-max scaled (the reference generator's defaults)."""
    from plssvm_sparse_fp22.cli.generate_data import generate, minmax_scale

    X, y = generate("blobs_merged", n, f, seed)
    return minmax_scale(X), y


def csr_data(n, f, density, seed):
    """Random CSR at ``density`` with no empty row; labels from a random
    hyperplane, so the data is learnable."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.uniform(-1.0, 1.0, size=k))
    lead = sp.csr_matrix((rng.uniform(0.5, 1.0, size=n),
                          (np.arange(n), rng.integers(0, f, size=n))),
                         shape=(n, f))
    csr = (csr + lead).tocsr()
    w = rng.normal(size=f)
    y = np.where(csr @ w > 0, 1.0, -1.0)
    return csr, y


def make_svm(data, y, kernel, *, dtype=np.float64, sparse=False, eps=1e-8,
             max_iter=MAX_ITER, devices=1):
    import scipy.sparse as sp

    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models import make_csvm
    from plssvm_sparse_fp22.params import Parameter

    f = data.shape[1]
    p = Parameter(kernel=kernel, gamma=1.0 / f, coef0=1.0, cost=1.0,
                  epsilon=eps, max_iter=max_iter, print_info=False,
                  dtype=dtype, devices=devices,
                  sparse_threshold=1.0 if sparse else -1.0)
    csr = data if sp.issparse(data) else sp.csr_matrix(data)
    dense = None if sp.issparse(data) else np.asarray(data, np.float64)
    p.data = ParsedData(csr=csr, values=y, _dense=dense)
    p.values = y
    return make_csvm(p)


def timed_learn(svm):
    t0 = time.perf_counter()
    svm.learn()
    return time.perf_counter() - t0


# ---------------------------------------------------------------- phases

def phase_kernel():
    """The hot operation as compiled for the card: XLA's implicit Gram
    matvec (``ops/matvec.build_operator``) at the exact tier against a
    plain ``jnp`` reference in f64 on the card, the TF32 tier with its own
    tolerance, its time and CG iterations/s, and what XLA makes of each
    dot precision."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from plssvm_sparse_fp22.models.base import _learn_jit
    from plssvm_sparse_fp22.ops.kernel_functions import gram_matrix
    from plssvm_sparse_fp22.ops.matvec import build_operator
    from plssvm_sparse_fp22.types import KernelType
    from plssvm_sparse_fp22.utils.timing import slope_rate

    hyper = dict(degree=3, coef0=1.0)
    rng = np.random.default_rng(0)

    def gram_matvec(X, kernel, precision=None, mode="implicit"):
        n, f = X.shape
        return build_operator(kernel, X, jnp.zeros(n, X.dtype),
                              jnp.ones(n, X.dtype), 0.0, 0.0, gamma=1.0 / f,
                              mode=mode, precision=precision, **hyper).matvec

    for n, f in KERNEL_SHAPES:
        X = jnp.asarray(rng.uniform(-1, 1, size=(n, f)), jnp.float32)
        v = jnp.asarray(rng.normal(size=n), jnp.float32)
        for kernel in KernelType:
            want = gram_matrix(kernel, X.astype(jnp.float64), gamma=1.0 / f,
                               **hyper) @ v.astype(jnp.float64)
            for name, prec, tol in (("exact", None, EXACT_TOL),
                                    ("tf32", lax.Precision.DEFAULT, TF32_TOL)):
                err = rel_err(gram_matvec(X, kernel, prec)(v), want)
                log(f"implicit matvec {kernel.name:10s} {n}x{f} {name:5s} "
                    f"rel_err {err:.3e} (tol {tol:.0e})")
                if not err <= tol:
                    fail(f"implicit matvec {kernel.name} {n}x{f} {name}: {err}")
            del want

    for n, f in TIMING_SHAPES:
        X = jnp.asarray(rng.uniform(-1, 1, size=(n, f)), jnp.float32)
        v0 = jnp.asarray(rng.normal(size=n), jnp.float32)
        for name, prec in (("exact", None), ("tf32", lax.Precision.DEFAULT)):
            t = best_time(lambda X, v: gram_matvec(X, KernelType.rbf, prec)(v),
                          X, v0, reps=5)
            log(f"implicit matvec rbf {n}x{f} {name}: {t * 1e3:.3f} ms")
        mask = jnp.ones(n, jnp.float32)

        def run(seed, iters):
            b = np.where(np.random.default_rng(seed).normal(size=n) > 0, 2.0, -2.0)
            t0 = time.perf_counter()
            out = jax.block_until_ready(_learn_jit(
                X, X[-1], jnp.asarray(b, jnp.float32), mask,
                jnp.float32(1.0 / f), jnp.float32(1.0), jnp.float32(1.0),
                jnp.float32(0.0), jnp.int32(iters), kernel=KernelType.rbf,
                degree=3, mode="implicit"))
            return time.perf_counter() - t0, int(out[4])

        log(f"_learn_jit implicit rbf {n}x{f}: "
            f"{slope_rate(run, 2, 8, trials=3):.3f} CG it/s")
        del X

    # what XLA makes of each dot precision for an f32 product
    A = jnp.asarray(rng.normal(size=(2048, 2048)), jnp.float32)
    ref = np.asarray(A, np.float64) @ np.asarray(A, np.float64)
    for prec in (lax.Precision.DEFAULT, lax.Precision.HIGH,
                 lax.Precision.HIGHEST):
        fn = jax.jit(lambda a, p=prec: jnp.dot(a, a, precision=p))
        hlo = fn.lower(A).compile().as_text()
        calls = re.findall(r'custom_call_target="([^"]+)"', hlo)
        algo = sorted(set(re.findall(r'"algorithm":"?([A-Z0-9_]+)', hlo)))
        operand = sorted(set(re.findall(r'"operand_precision":\[([^\]]*)\]',
                                        hlo)))
        log(f"precision {prec.name}: rel_err vs f64 "
            f"{rel_err(fn(A), ref):.3e}; calls {calls}; operand_precision "
            f"{operand}; algorithm {algo}")


def phase_oracle():
    from plssvm_sparse_fp22.types import KernelType
    from plssvm_sparse_fp22.utils import oracle

    for n, f in ORACLE_SHAPES:
        m = ORACLE_TEST_POINTS
        for storage in ("dense", "csr"):
            if storage == "dense":
                data, y = dense_data(n + m, f, seed=n + f)
                Xd = data
            else:
                data, y = csr_data(n + m, f, 0.01, seed=n + f + 1)
                Xd = data.toarray()
            train, test = data[:n], Xd[n:]
            y_train, Xt = y[:n], Xd[:n]
            for kernel in KernelType:
                hyper = dict(degree=3, gamma=1.0 / f, coef0=1.0)
                alpha, bias, info = oracle.solve_lssvm(
                    Xt, y_train, kernel=kernel, cost=1.0, epsilon=ORACLE_EPS,
                    max_iter=MAX_ITER, **hyper)
                want_labels = np.where(oracle.predict_values(
                    Xt, alpha, bias, test, kernel=kernel, **hyper) > 0, 1.0, -1.0)
                if kernel == KernelType.linear:
                    runs = [("linear", {})]
                elif storage == "dense":
                    runs = [("cached", {}), ("implicit", {"PLSSVM_K_CACHE_BYTES": 1})]
                else:
                    runs = [("gram", {"PLSSVM_SPARSE_MODE": "gram"}),
                            ("dense", {"PLSSVM_SPARSE_MODE": "dense"})]
                for label, extra in runs:
                    with env(**extra):
                        svm = make_svm(train, y_train, kernel, eps=ORACLE_EPS,
                                       sparse=storage == "csr")
                        secs = timed_learn(svm)
                    got_labels = svm.predict_label(test)
                    info_ = svm.last_cg_info
                    a_err = rel_err(svm.alphas, alpha)
                    log(f"oracle {storage:5s} {n}x{f} {kernel.name:10s} "
                        f"{label:8s} mode {info_['mode']:22s} it {info_['iterations']:4d} "
                        f"(oracle {info['iterations']:4d}) {secs:7.3f} s "
                        f"alpha rel_err {a_err:.2e}")
                    np.testing.assert_allclose(svm.alphas, alpha, **GOLDEN)
                    np.testing.assert_allclose(svm.bias_, bias, **GOLDEN)
                    if not np.array_equal(got_labels, want_labels):
                        fail(f"oracle labels {storage} {n}x{f} {kernel.name} {label}")
                if kernel != KernelType.linear and storage == "dense":
                    # f32 implicit (the --use_float route)
                    with env(PLSSVM_K_CACHE_BYTES=1):
                        svm = make_svm(train, y_train, kernel, dtype=np.float32,
                                       eps=1e-6)
                        secs = timed_learn(svm)
                    agree = float(np.mean(svm.predict_label(test) == want_labels))
                    log(f"oracle dense {n}x{f} {kernel.name:10s} f32 implicit "
                        f"mode {svm.last_cg_info['mode']} it "
                        f"{svm.last_cg_info['iterations']} {secs:.3f} s "
                        f"alpha rel_err {rel_err(svm.alphas, alpha):.2e} "
                        f"label agreement {agree:.4f}")
                    if agree < 0.99:
                        fail(f"f32 implicit learn {n}x{f} {kernel.name}: {agree}")


def _cli(main, argv):
    """Run a CLI ``main`` in-process; return (stdout, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        fail(f"{main.__module__} {argv} returned {rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue(), secs


def phase_cli(seed):
    from plssvm_sparse_fp22.cli.generate_data import main as generate
    from plssvm_sparse_fp22.cli.predict import main as predict
    from plssvm_sparse_fp22.cli.train import main as train
    from plssvm_sparse_fp22.ops.matvec import choose_mode
    from plssvm_sparse_fp22.types import KernelType

    n_train, n_test, n_half, f = CLI_SHAPE
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        base = os.path.join(tmp, "blobs")
        _, secs = _cli(generate, [
            "--output", base, "--format", "libsvm", "--samples", str(n_train),
            "--test_samples", str(n_test), "--features", str(f), "--problem",
            "blobs_merged", "--minmax_scale", "--seed", str(seed)])
        log(f"cli generate {n_train}+{n_test} x {f}: {secs:.1f} s")
        half = os.path.join(tmp, "half.libsvm")
        with open(base + ".libsvm") as src, open(half, "w") as dst:
            for i, line in enumerate(src):
                if i == n_half:
                    break
                dst.write(line)
        test = base + "_test.libsvm"
        model = os.path.join(tmp, "m.model")
        # CG starts at x = 1 and stops at a residual relative to that
        # start.  For the linear kernel |A 1| is about n*f times |b|, so
        # -e 1e-6 stopped the 65536x256 learn at a residual near |b|
        # (12 iterations, 83.5 % held out, on the H100 and likewise on
        # the CPU); -e 1e-8 converges (41 iterations, 99.9 % on the CPU)
        runs = ((base + ".libsvm", n_train, "2", KernelType.rbf, "1e-6"),
                (half, n_half, "2", KernelType.rbf, "1e-6"),
                (base + ".libsvm", n_train, "0", KernelType.linear, "1e-8"))
        for path, n, t, kernel, eps in runs:
            mode = choose_mode(kernel, n - 1, np.float32)
            out, secs = _cli(train, ["-t", t, "--use_float", "-e", eps,
                                     path, model])
            m = re.search(r"Finished after (\d+) iterations", out)
            iters = int(m.group(1))
            pout, psecs = _cli(predict, [test, model, os.path.join(tmp, "p")])
            acc = float(re.search(r"Accuracy = ([0-9.]+)%", pout).group(1)) / 100
            log(f"cli train -t {t} {n}x{f} mode {mode}: {iters} iterations, "
                f"{secs:.2f} s; predict {n_test}: {psecs:.2f} s, accuracy {acc:.4f}")
            if iters >= f:
                fail(f"cli train -t {t} {n}: no convergence before imax")
            if acc < CLI_MIN_ACCURACY:
                fail(f"cli accuracy {acc} < {CLI_MIN_ACCURACY}")


def phase_sparse():
    from plssvm_sparse_fp22.types import KernelType

    for name, n, f, density, extra, want_mode in SPARSE_CASES:
        csr, y = csr_data(n, f, density, seed=n)
        svm_d = make_svm(csr.toarray(), y, KernelType.rbf, eps=ORACLE_EPS)
        secs_d = timed_learn(svm_d)
        with env(**extra):
            svm_s = make_svm(csr, y, KernelType.rbf, sparse=True, eps=ORACLE_EPS)
            secs_s = timed_learn(svm_s)
        pts = csr[:4096].toarray()
        same = np.array_equal(svm_s.predict_label(pts), svm_d.predict_label(pts))
        log(f"sparse {name} {n}x{f}@{density}: {svm_s.last_cg_info['mode']} "
            f"{svm_s.last_cg_info['iterations']} it {secs_s:.2f} s; dense "
            f"{svm_d.last_cg_info['mode']} {svm_d.last_cg_info['iterations']} it "
            f"{secs_d:.2f} s; alpha rel_err "
            f"{rel_err(svm_s.alphas, svm_d.alphas):.2e}, labels identical {same}")
        if svm_s.last_cg_info["mode"] != want_mode:
            fail(f"sparse {name} took {svm_s.last_cg_info['mode']}")
        np.testing.assert_allclose(svm_s.alphas, svm_d.alphas, **GOLDEN)
        np.testing.assert_allclose(svm_s.bias_, svm_d.bias_, **GOLDEN)
        if not same:
            fail(f"sparse {name}: labels differ from the dense learn")


def phase_four():
    import jax
    import jax.numpy as jnp

    from plssvm_sparse_fp22.models.base import _learn_jit
    from plssvm_sparse_fp22.parallel.mesh import make_mesh
    from plssvm_sparse_fp22.parallel.sharded import make_sharded_learn, shard_system
    from plssvm_sparse_fp22.types import KernelType

    if jax.device_count() < 4:
        fail(f"--four needs 4 GPUs, found {jax.device_count()}")
    devs = set(jax.devices()[:4])

    # the ring learn step: inputs and solution span the mesh, and it agrees
    # with the one-device learn (f64, both CG to ORACLE_EPS)
    n, f = FOUR_RING
    X, y = dense_data(n, f, seed=4)
    dept = n - 1
    X_pad = np.zeros((n, f))
    X_pad[:dept] = X[:dept]
    b = np.zeros(n)
    b[:dept] = y[:dept] - y[-1]
    mask = np.zeros(n)
    mask[:dept] = 1.0
    scalars = (jnp.float64(1 / f), jnp.float64(1.0), jnp.float64(1.0),
               jnp.float64(ORACLE_EPS), jnp.int32(MAX_ITER))
    x_last = jnp.asarray(X[-1])
    mesh = make_mesh(4)
    Xs, bs, ms = shard_system(mesh, X_pad, b, mask)
    learn = make_sharded_learn(mesh, KernelType.rbf, 3, "implicit")
    t0 = time.perf_counter()
    out = jax.block_until_ready(learn(Xs, x_last, bs, ms, *scalars))
    t4 = time.perf_counter() - t0
    for name, arr in (("X", Xs), ("b", bs), ("x", out[0])):
        if set(arr.sharding.device_set) != devs:
            fail(f"sharded {name} lives on {arr.sharding.device_set}")
    t0 = time.perf_counter()
    one = jax.block_until_ready(_learn_jit(
        jnp.asarray(X_pad), x_last, jnp.asarray(b), jnp.asarray(mask),
        *scalars, kernel=KernelType.rbf, degree=3, mode="implicit"))
    t1 = time.perf_counter() - t0
    log(f"four: ring learn {n}x{f} f64 {int(out[4])} it {t4:.2f} s "
        f"(one device {int(one[4])} it {t1:.2f} s), x rel_err "
        f"{rel_err(out[0], one[0]):.2e}; x sharding {out[0].sharding}")
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(one[0]), **GOLDEN)

    # the product surface: learn() spans every device it is given
    for i, (name, n, f, density, kname, extra, want_mode) in enumerate(FOUR_CASES):
        sparse = density is not None
        data, yy = (csr_data(n, f, density, seed=5 + i) if sparse
                    else dense_data(n, f, seed=5 + i))
        kernel = KernelType.from_string(kname)
        one = make_svm(data, yy, kernel, eps=ORACLE_EPS, sparse=sparse,
                       devices=1)
        t1 = timed_learn(one)
        with env(**extra):
            four = make_svm(data, yy, kernel, eps=ORACLE_EPS, sparse=sparse,
                            devices=4)
            t4 = timed_learn(four)
        pts = data[:2048]
        pts = pts.toarray() if hasattr(pts, "toarray") else pts
        same = np.array_equal(four.predict_label(pts), one.predict_label(pts))
        log(f"four {name}: {four.last_cg_info['mode']} "
            f"{four.last_cg_info['iterations']} it {t4:.2f} s vs one device "
            f"{one.last_cg_info['mode']} {one.last_cg_info['iterations']} it "
            f"{t1:.2f} s; alpha rel_err {rel_err(four.alphas, one.alphas):.2e}, "
            f"labels identical {same}")
        if four.last_cg_info["mode"] != want_mode:
            fail(f"four {name} took {four.last_cg_info['mode']}")
        np.testing.assert_allclose(four.alphas, one.alphas, **GOLDEN)
        np.testing.assert_allclose(four.bias_, one.bias_, **GOLDEN)
        if not same:
            fail(f"four {name}: labels differ from the one-device learn")


def implicit_step_memory():
    """memory_analysis() of the compiled implicit learn step (65536x256
    rbf, f32)."""
    import jax
    import jax.numpy as jnp

    from plssvm_sparse_fp22.models.base import _learn_jit
    from plssvm_sparse_fp22.types import KernelType

    D, f = 65536, 256
    X = jax.ShapeDtypeStruct((D, f), jnp.float32)
    vec = jax.ShapeDtypeStruct((D,), jnp.float32)
    s = jax.ShapeDtypeStruct((), jnp.float32)
    compiled = _learn_jit.lower(
        X, jax.ShapeDtypeStruct((f,), jnp.float32), vec, vec, s, s, s, s,
        jax.ShapeDtypeStruct((), jnp.int32), kernel=KernelType.rbf, degree=3,
        mode="implicit").compile()
    log(f"implicit learn step 65536x256 memory_analysis: "
        f"{compiled.memory_analysis()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import jax

    from plssvm_sparse_fp22.utils.compilation_cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found '{dev.platform}'")
    jax.config.update("jax_enable_x64", True)
    log(f"card (name, power.limit): {card_line()}")
    log(f"jax {jax.__version__}; devices {jax.devices()}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
        f"{enable_compilation_cache()}")

    if args.four:
        phases = [("four", phase_four)]
    else:
        implicit_step_memory()
        phases = [("kernel", phase_kernel), ("oracle", phase_oracle),
                  ("cli", lambda: phase_cli(args.seed)),
                  ("sparse", phase_sparse)]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        fn()
        log(f"== phase {name} passed in {time.perf_counter() - t0:.1f} s")
    stats = dev.memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')} of bytes_limit "
        f"{stats.get('bytes_limit')}")
    log(f"card (name, power.limit): {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}))


if __name__ == "__main__":
    main()
