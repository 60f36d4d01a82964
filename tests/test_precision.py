"""Typed precision matrix: {float32, float64} x {linear, polynomial, rbf}.

Analog of the reference's typed test instantiation over
{float, double} x kernels (``tests/backends/OpenMP/test.cpp:29-39``).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import plssvm_sparse_fp22 as pt
from plssvm_sparse_fp22.io.libsvm import ParsedData
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType

from utils import make_blobs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.polynomial, KernelType.rbf])
def test_learn_predict_typed(dtype, kernel):
    X, y = make_blobs(60, 10, seed=21)
    p = Parameter(dtype=dtype, kernel=kernel, coef0=1.0, max_iter=200, epsilon=1e-6)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    p.gamma = 1.0 / X.shape[1]
    svm = pt.make_csvm(p)
    svm.print_info = False
    svm.learn()
    assert svm.dtype == np.dtype(dtype)
    assert svm.accuracy() >= 0.95
    # predictions are finite, labels in {-1, 1}
    out = svm.predict(X[:7])
    assert np.all(np.isfinite(out))
    assert set(np.unique(svm.predict_label(X[:7]))) <= {-1.0, 1.0}


def test_verbose_cg_prints_iterations(capsys):
    X, y = make_blobs(40, 6, seed=4)
    p = Parameter(dtype=np.float64, verbose_cg=True, max_iter=50, epsilon=1e-6)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    p.gamma = 1.0 / X.shape[1]
    svm = pt.make_csvm(p)
    svm.learn()
    out = capsys.readouterr().out
    assert "Start Iteration 1 (max: 50) with current residuum" in out
    assert "Finished after" in out


class TestF64ImplicitContract:
    """f64 on the implicit path: the blocked XLA matvec computes exact f64
    (cuBLAS runs f64 GEMMs natively on the GPU)."""

    def test_build_operator_routes_f64_implicit_to_xla(self):
        """An f64 implicit operator is the blocked XLA matvec at full f64
        precision."""
        import jax.numpy as jnp

        from plssvm_sparse_fp22.ops.matvec import build_operator
        from plssvm_sparse_fp22.utils import oracle

        rng = np.random.default_rng(1)
        D, f = 256, 8
        dept = 200
        X = np.zeros((D, f))
        X[:dept] = rng.normal(size=(dept, f))
        mask = np.zeros(D)
        mask[:dept] = 1.0
        q = rng.normal(size=D) * mask
        op = build_operator(
            KernelType.rbf, jnp.asarray(X), jnp.asarray(q), jnp.asarray(mask),
            2.0, 0.5, gamma=0.125, mode="implicit",
        )
        v = rng.normal(size=D) * mask
        got = np.asarray(op.matvec(jnp.asarray(v)))
        assert got.dtype == np.float64
        # full-f64 oracle: K v + corrections
        K = oracle.kernel_matrix(KernelType.rbf, X[:dept], X[:dept],
                                 gamma=0.125)
        s, t = v.sum(), q @ v
        want = np.zeros(D)
        want[:dept] = K @ v[:dept] + (2.0 * s - t) - s * q[:dept] + 0.5 * v[:dept]
        want -= (1 - mask) * s * q  # padding rows: -s*q is unmasked there
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.polynomial,
                                    KernelType.rbf])
def test_implicit_f64_matvec_exact(kernel):
    """The blocked implicit matvec in f64 equals the f64 oracle to
    rounding, for every kernel (no kernel path downgrades f64)."""
    import jax.numpy as jnp

    from plssvm_sparse_fp22.ops.matvec import build_operator
    from plssvm_sparse_fp22.utils import oracle

    rng = np.random.default_rng(2)
    D, f = 256, 12
    X = rng.normal(size=(D, f))
    hyper = dict(degree=3, gamma=0.1, coef0=1.0)
    op = build_operator(kernel, jnp.asarray(X), jnp.zeros(D), jnp.ones(D),
                        0.0, 0.0, mode="implicit", **hyper)
    v = rng.normal(size=D)
    got = np.asarray(op.matvec(jnp.asarray(v)))
    assert got.dtype == np.float64
    want = oracle.kernel_matrix(kernel, X, X, **hyper) @ v
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
