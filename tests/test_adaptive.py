"""Adaptive two-tier CG (``solver/cg.cg_solve_adaptive``).

On a GPU the fast tier is a reduced-precision tensor-core product (TF32 or
bf16, docs/PERF.md "Dot precision on the H100"); on the CPU test platform
both tiers are numerically identical, so the *escalation machinery* is
exercised with a deliberately corrupted fast matvec whose error floor sits
above the requested tolerance — the same failure mode a too-coarse tier
produces on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from plssvm_sparse_fp22.solver.cg import (CGState, cg_init,
                                              cg_run_stagnation,
                                              cg_solve, cg_solve_adaptive)

from utils import make_blobs


def _spd_system(n=48, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    A = (M @ M.T / n + np.eye(n) * 2.0).astype(dtype)
    b = rng.normal(size=n).astype(dtype)
    mask = np.ones(n, dtype)
    return jnp.asarray(A), jnp.asarray(b), jnp.asarray(mask)


def _noisy_matvec(A, mask, level):
    """A @ v plus a deterministic nonlinear perturbation of relative size
    ``level`` — the stand-in for a low-precision tier's error floor (CG's
    recurrence cannot push the true residual below it)."""

    def mv(v):
        Av = jnp.dot(A, v)
        noise = level * jnp.linalg.norm(Av) * jnp.sin(v * 7919.0) / A.shape[0] ** 0.5
        return (Av + noise) * mask

    return mv


def exact_matvec(A, mask):
    def mv(v):
        return jnp.dot(A, v) * mask

    return mv


def test_adaptive_escalates_and_converges():
    """Fast tier floors at ~1e-3; the solve must detect it, re-enter on the
    accurate tier, and meet the 1e-6-grade target it could never reach."""
    A, b, mask = _spd_system()
    eps = 1e-5
    res = cg_solve_adaptive(
        _noisy_matvec(A, mask, 1e-3), exact_matvec(A, mask),
        b, mask, eps, imax=200,
    )
    assert float(res.delta) <= eps ** 2 * float(res.delta0)
    assert int(res.iterations) > int(res.fast_iterations) > 0  # escalated
    x_ref = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-3, atol=2e-3)


def test_adaptive_stays_fast_when_sufficient():
    """Identical tiers: the fast stage converges, the accurate-tier residual
    check passes, and no escalation iterations run."""
    A, b, mask = _spd_system(seed=3)
    eps = 1e-5
    mv = exact_matvec(A, mask)
    res = cg_solve_adaptive(mv, mv, b, mask, eps, imax=200)
    assert float(res.delta) <= eps ** 2 * float(res.delta0)
    assert int(res.iterations) == int(res.fast_iterations)
    # and it matches the plain solve exactly (same loop, same operator)
    ref = cg_solve(mv, b, mask, eps, 200)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x), rtol=1e-6)


def test_adaptive_eps_zero_pins_fast_tier():
    """eps = 0 (the benchmark's fixed-iteration mode): stagnation and
    escalation disarm — all iterations run on the fast tier even though the
    noisy residual can never reach zero."""
    A, b, mask = _spd_system(seed=5)
    res = cg_solve_adaptive(
        _noisy_matvec(A, mask, 1e-3), exact_matvec(A, mask),
        b, mask, 0.0, imax=40,
    )
    # every executed iteration ran on the fast tier; the count is imax
    # unless the f32 recurrence residual underflowed to an exact 0.0 (the
    # documented eps=0 early exit, shared with cg_solve — benchmarks divide
    # by EXECUTED iterations for exactly this reason)
    assert int(res.iterations) == int(res.fast_iterations)
    assert int(res.iterations) == 40 or float(res.delta) == 0.0


def test_stagnation_exit_fires():
    """The stagnation runner alone: with a noisy matvec and an unreachable
    target it must exit long before imax (patience window), not spin."""
    A, b, mask = _spd_system(seed=7)
    mv = _noisy_matvec(A, mask, 1e-2)
    state = cg_init(mv, b, mask)
    # refresh_interval=1 keeps delta equal to the (noisy) true residual, so
    # it visibly floors; with the default 50-step refresh the recurrence can
    # sail below the floor — that case is caught by the verify step instead
    # (test_adaptive_escalates_and_converges)
    state = cg_run_stagnation(mv, b, mask, 1e-8, 500, state, patience=6,
                              refresh_interval=1)
    assert int(state.k) < 500
    assert float(state.delta) > (1e-8) ** 2 * float(state.delta0)  # stagnated


def test_stagnation_respects_convergence_and_imax():
    A, b, mask = _spd_system(seed=9)
    mv = exact_matvec(A, mask)
    state = cg_init(mv, b, mask)
    out = cg_run_stagnation(mv, b, mask, 1e-6, 500, state, patience=6)
    assert float(out.delta) <= 1e-12 * float(out.delta0)
    state = cg_init(mv, b, mask)
    out = cg_run_stagnation(mv, b, mask, 1e-6, 3, state, patience=6)
    assert int(out.k) == 3


def test_adaptive_preconditioned():
    """The adaptive solve composes with the Jacobi preconditioner (minv is
    tier-independent)."""
    A, b, mask = _spd_system(seed=11)
    minv = mask / jnp.diagonal(A)
    eps = 1e-5
    res = cg_solve_adaptive(
        _noisy_matvec(A, mask, 1e-3), exact_matvec(A, mask),
        b, mask, eps, imax=200, minv=minv,
    )
    assert float(res.delta) <= eps ** 2 * float(res.delta0)
    x_ref = np.linalg.solve(np.asarray(A, np.float64), np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-3, atol=2e-3)


def test_product_surface_adaptive(monkeypatch):
    """PLSSVM_MATMUL_PRECISION=adaptive through make_csvm: the learn takes
    the two-tier path (fast_iterations reported), converges to the
    accurate-tier tolerance, and trains to full accuracy.  A one-byte K
    budget forces the implicit mode the plan applies to.  Escalation may or
    may not fire depending on where the fast tier's error floor lands —
    either way the verified contract must hold."""
    import scipy.sparse as sp

    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models import make_csvm
    from plssvm_sparse_fp22.params import Parameter
    from plssvm_sparse_fp22.types import BackendType, KernelType

    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1")
    X, y = make_blobs(96, 16, dtype=np.float32)
    params = Parameter(kernel=KernelType.rbf, gamma=1.0 / 16, cost=1.0,
                       epsilon=1e-6, print_info=False, dtype=np.float32,
                       backend=BackendType.automatic, devices=1)
    params.data = ParsedData(csr=sp.csr_matrix(X), values=y,
                             _dense=X.astype(np.float64))
    params.values = y
    svm = make_csvm(params)
    svm.learn()
    info = svm.last_cg_info
    assert info["mode"] == "implicit"
    assert "fast_iterations" in info and info["fast_iterations"] >= 1
    assert info["delta"] <= 1e-12 * info["delta0"]  # accurate-tier residual
    assert svm.accuracy() == pytest.approx(1.0)


def test_sharded_adaptive_product_surface(monkeypatch):
    """Forced adaptive through the row-sharded multi-chip learn: the
    two-tier CG runs inside shard_map (psummed dots on both tiers) and the
    fast-iteration count surfaces in last_cg_info."""
    import scipy.sparse as sp

    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models import make_csvm
    from plssvm_sparse_fp22.params import Parameter
    from plssvm_sparse_fp22.types import KernelType

    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    X, y = make_blobs(1100, 16, dtype=np.float32)
    params = Parameter(kernel=KernelType.linear, cost=1.0, epsilon=1e-6,
                       print_info=False, dtype=np.float32, devices=8)
    params.data = ParsedData(csr=sp.csr_matrix(X), values=y,
                             _dense=X.astype(np.float64))
    params.values = y
    svm = make_csvm(params)
    svm.learn()
    info = svm.last_cg_info
    assert info["mode"].startswith("sharded_")
    assert "fast_iterations" in info and info["escalated"] is False
    assert svm.accuracy() > 0.97


def test_resolve_precision_plan_contract(monkeypatch):
    from plssvm_sparse_fp22.ops.matvec import resolve_precision_plan

    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "adaptive")
    # the accurate tier is exact f32: on the H100 "high" is TF32 like "default"
    assert resolve_precision_plan("implicit", np.float32) == ("default", "highest")
    assert resolve_precision_plan("linear", np.float32) == ("default", "highest")
    assert resolve_precision_plan("cached", np.float32) is None  # HBM-bound
    assert resolve_precision_plan("implicit", np.float64) is None  # exact f64
    monkeypatch.setenv("PLSSVM_MATMUL_PRECISION", "high")
    assert resolve_precision_plan("implicit", np.float32) is None  # pinned tier
    monkeypatch.delenv("PLSSVM_MATMUL_PRECISION")
    # default: fixed tier on every platform until the GPU tiers are
    # measured against the escalation fixture
    assert resolve_precision_plan("implicit", np.float32) is None
