"""Solver-layer tests: implicit matvec and CG against the numpy oracle.

Port of the reference's ``device_kernel_test`` / ``generate_q_test``
(``tests/backends/generic_tests.hpp:121-227``): the device compute path is
checked against an independent sequential implementation, typed over
{float32, float64} x {linear, polynomial, rbf}.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from plssvm_sparse_fp22.ops.kernel_functions import gram_block, kernel_scalar
from plssvm_sparse_fp22.ops.matvec import build_operator
from plssvm_sparse_fp22.solver.cg import cg_solve
from plssvm_sparse_fp22.types import KernelType
from plssvm_sparse_fp22.utils import oracle

from utils import make_blobs

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}


def _setup_system(n=33, f=7, dtype=np.float64, seed=0):
    X, y = make_blobs(n, f, seed=seed)
    dept = n - 1
    D = 64  # padded
    cost = 2.0
    X_pad = np.zeros((D, f), dtype=dtype)
    X_pad[:dept] = X[:dept]
    mask = np.zeros(D, dtype=dtype)
    mask[:dept] = 1.0
    return X, y, X_pad, mask, dept, D, cost


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gram_block_matches_oracle(kernel, dtype):
    X, _ = make_blobs(20, 5)
    K = np.asarray(
        gram_block(kernel, jnp.asarray(X[:12], dtype), jnp.asarray(X, dtype), **HYPER)
    )
    K_ref = oracle.kernel_matrix(kernel, X[:12], X, **HYPER)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(K, K_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_scalar(kernel):
    X, _ = make_blobs(4, 6)
    got = float(kernel_scalar(kernel, jnp.asarray(X[0]), jnp.asarray(X[1]), **HYPER))
    want = oracle.kernel_function(kernel, X[0], X[1], **HYPER)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mode", ["linear", "cached", "implicit"])
def test_matvec_matches_explicit_matrix(kernel, mode):
    """A v from the operator == A v from the explicitly assembled matrix."""
    if mode == "linear" and kernel != KernelType.linear:
        pytest.skip("mode 'linear' is linear-kernel only")
    X, y, X_pad, mask, dept, D, cost = _setup_system()
    cost_inv = 1.0 / cost

    q_short = oracle.generate_q(kernel, X, **HYPER)
    q = np.zeros(D)
    q[:dept] = q_short
    QA = oracle.kernel_function(kernel, X[-1], X[-1], **HYPER) + cost_inv

    op = build_operator(
        kernel, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask), QA, cost_inv,
        mode=mode, row_block=32, **HYPER,
    )

    rng = np.random.default_rng(1)
    v = np.zeros(D)
    v[:dept] = rng.normal(size=dept)

    got = np.asarray(op.matvec(jnp.asarray(v)))
    want = oracle.implicit_matvec(kernel, X, q_short, QA, cost_inv, v[:dept], **HYPER)

    np.testing.assert_allclose(got[:dept], want, rtol=1e-10, atol=1e-10)
    # padding stays exactly zero (the invariant CG relies on)
    np.testing.assert_array_equal(got[dept:], np.zeros(D - dept))


@pytest.mark.parametrize("kernel", KERNELS)
def test_cg_matches_oracle(kernel):
    """Full CG trajectory: same iteration count, solution, residuals."""
    X, y, X_pad, mask, dept, D, cost = _setup_system(n=49, f=16)
    cost_inv = 1.0 / cost
    eps = 0.001

    q_short = oracle.generate_q(kernel, X, **HYPER)
    q = np.zeros(D)
    q[:dept] = q_short
    QA = oracle.kernel_function(kernel, X[-1], X[-1], **HYPER) + cost_inv
    b = np.zeros(D)
    b[:dept] = y[:dept] - y[-1]

    op = build_operator(
        kernel, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask), QA, cost_inv,
        mode="cached", **HYPER,
    )
    res = cg_solve(op.matvec, jnp.asarray(b), jnp.asarray(mask), eps, imax=16)

    alpha_ref, bias_ref, info = oracle.solve_lssvm(
        X, y, kernel=kernel, cost=cost, epsilon=eps, max_iter=16, **HYPER
    )

    assert int(res.iterations) == info["iterations"]
    np.testing.assert_allclose(np.asarray(res.x)[:dept], alpha_ref[:dept], rtol=1e-8, atol=1e-10)
    assert float(res.delta0) == pytest.approx(info["delta0"], rel=1e-10)
    assert float(res.delta) == pytest.approx(info["delta"], rel=1e-6, abs=1e-12)


def test_jacobi_pcg_converges_faster():
    """Jacobi-preconditioned CG reaches the same solution in fewer (or equal)
    iterations on a badly row-scaled system; the stopping criterion stays on
    the plain residual (capability extension over the reference)."""
    from plssvm_sparse_fp22.models.base import _jacobi_minv

    rng = np.random.default_rng(11)
    n, f = 120, 300
    # strongly varying ROW norms -> strongly varying implicit-matrix diagonal
    # (the regime where a diagonal preconditioner pays off)
    row_scale = rng.permutation(np.geomspace(0.1, 30.0, n))
    X = rng.normal(size=(n, f)) * row_scale[:, None]
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    kernel = KernelType.linear
    hyper = {"degree": 3, "gamma": 0.5, "coef0": 0.0}
    dept, D, eps = n - 1, 128, 1e-8

    X_pad = np.zeros((D, f))
    X_pad[:dept] = X[:dept]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    q_short = oracle.generate_q(kernel, X, **hyper)
    q = np.zeros(D)
    q[:dept] = q_short
    QA = oracle.kernel_function(kernel, X[-1], X[-1], **hyper) + 1.0
    b = np.zeros(D)
    b[:dept] = y[:dept] - y[-1]

    op = build_operator(
        kernel, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask), QA, 1.0,
        mode="cached", **hyper,
    )
    res_plain = cg_solve(op.matvec, jnp.asarray(b), jnp.asarray(mask), eps, imax=300)
    minv = _jacobi_minv(
        kernel, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask),
        jnp.float64(QA), jnp.float64(1.0),
        hyper["degree"], hyper["gamma"], hyper["coef0"],
    )
    res_pcg = cg_solve(op.matvec, jnp.asarray(b), jnp.asarray(mask), eps,
                       imax=300, minv=minv)

    assert int(res_pcg.iterations) < int(res_plain.iterations)
    # both stopped on the same plain-residual criterion
    assert float(res_pcg.delta) <= eps**2 * float(res_pcg.delta0)
    # two approximate solutions at the same residual tolerance of an
    # ill-conditioned system agree only to ~ ||r|| / lambda_min; compare
    # loosely — the binding invariants are the residual target and the
    # iteration-count reduction above
    scale = np.max(np.abs(np.asarray(res_plain.x)))
    np.testing.assert_allclose(np.asarray(res_pcg.x)[:dept],
                               np.asarray(res_plain.x)[:dept],
                               rtol=0.2, atol=5e-2 * scale)


def test_precond_via_model_api():
    """precond='jacobi' through the CSVM API gives the same model."""
    import scipy.sparse as sp

    from plssvm_sparse_fp22.io.libsvm import ParsedData
    from plssvm_sparse_fp22.models.factory import make_csvm
    from plssvm_sparse_fp22.params import Parameter

    X, y = make_blobs(80, 10, seed=9)
    out = {}
    for precond in ("none", "jacobi"):
        p = Parameter(kernel=KernelType.rbf, gamma=0.1, cost=2.0, epsilon=1e-6,
                      data=ParsedData(csr=sp.csr_matrix(X), values=y), values=y,
                      print_info=False, precond=precond, sparse_threshold=0.0)
        m = make_csvm(p)
        m.learn()
        out[precond] = (np.asarray(m.alphas), m.bias_, m.last_cg_info["iterations"])
    scale = np.max(np.abs(out["none"][0]))
    np.testing.assert_allclose(out["jacobi"][0], out["none"][0],
                               rtol=0.1, atol=5e-3 * scale)
    assert out["jacobi"][1] == pytest.approx(out["none"][1], rel=5e-2, abs=5e-3)


def test_cg_refresh_interval_semantics():
    """Runs > 50 iterations exercise the r = b - A x refresh branch."""
    # an ill-conditioned random system forces many CG iterations
    rng = np.random.default_rng(7)
    n, f = 120, 200
    X = rng.normal(size=(n, f)) * np.geomspace(1, 100, f)
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    kernel = KernelType.linear  # spread Gram spectrum -> ~155 CG iterations
    hyper = {"degree": 3, "gamma": 0.5, "coef0": 0.0}

    dept = n - 1
    D = 128
    X_pad = np.zeros((D, f))
    X_pad[:dept] = X[:dept]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    q_short = oracle.generate_q(kernel, X, **hyper)
    q = np.zeros(D)
    q[:dept] = q_short
    QA = oracle.kernel_function(kernel, X[-1], X[-1], **hyper) + 1.0
    b = np.zeros(D)
    b[:dept] = y[:dept] - y[-1]

    op = build_operator(
        kernel, jnp.asarray(X_pad), jnp.asarray(q), jnp.asarray(mask), QA, 1.0,
        mode="cached", **hyper,
    )
    eps = 1e-8  # tight tolerance: forces > 50 iterations
    res = cg_solve(op.matvec, jnp.asarray(b), jnp.asarray(mask), eps, imax=200)
    alpha_ref, _, info = oracle.solve_lssvm(
        X, y, kernel=kernel, cost=1.0, epsilon=eps, max_iter=200, **hyper
    )
    assert info["iterations"] > 50  # the refresh branch actually ran
    # after 150+ iterations, FP summation-order differences between XLA and
    # numpy can shift the convergence boundary by an iteration or two
    assert abs(int(res.iterations) - info["iterations"]) <= 3
    # two runs stopped at the same residual tolerance are equally valid
    # approximate solutions; compare loosely
    np.testing.assert_allclose(np.asarray(res.x)[:dept], alpha_ref[:dept], rtol=1e-3, atol=1e-5)
    assert float(res.delta) <= 1e-16 * float(res.delta0)
