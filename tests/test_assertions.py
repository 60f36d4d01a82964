"""Debug-assert layer tests (PLSSVM_ASSERT analog, ``assert.hpp:36-65``).

The reference covers its assert macro with a death test
(``tests/base_test.cpp`` assert death test); here the Python equivalent
checks the exception, the message format, and the enable switch.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from plssvm_sparse_fp22.utils import assertions
from plssvm_sparse_fp22.utils.assertions import (
    PLSSVMAssertionError, plssvm_assert)


class TestPlssvmAssert:
    def test_disabled_is_noop(self, monkeypatch):
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", False)
        plssvm_assert(False, "never raised")  # must not raise

    def test_enabled_passes_on_true(self, monkeypatch):
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", True)
        plssvm_assert(True, "fine")

    def test_enabled_raises_with_location(self, monkeypatch):
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", True)
        with pytest.raises(PLSSVMAssertionError) as exc:
            plssvm_assert(False, "x must be {}, got {}", 4, 5)
        msg = str(exc.value)
        # formatted message + source-located frame (what_with_loc parity)
        assert "Assertion 'x must be 4, got 5' failed!" in msg
        assert "test_assertions.py" in msg
        assert "in function" in msg

    def test_lazy_formatting(self, monkeypatch):
        """The message is only formatted on failure — a bad format spec
        must not break a passing assert."""
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", True)
        plssvm_assert(True, "{0} {1}")  # would raise IndexError if formatted

    def test_env_switch_read_at_import(self, monkeypatch):
        """Documented contract: the env var acts like the reference's
        compile-time macro — setting it post-import has no effect on the
        already-imported module, and a fresh interpreter honors it."""
        import subprocess
        import sys

        before = assertions.ASSERTS_ENABLED
        monkeypatch.setenv("PLSSVM_ENABLE_ASSERTS", "1")
        assert assertions.ASSERTS_ENABLED == before  # unchanged post-import
        for env_val, expect in (("1", "True"), ("0", "False")):
            out = subprocess.run(
                [sys.executable, "-c",
                 "from plssvm_sparse_fp22.utils import assertions; "
                 "print(assertions.ASSERTS_ENABLED)"],
                env={**os.environ, "PLSSVM_ENABLE_ASSERTS": env_val,
                     "JAX_PLATFORMS": "cpu"},
                capture_output=True, text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            )
            assert out.stdout.strip() == expect, out.stderr


class TestWiredInvariants:
    """The assert layer guards real internal invariants when enabled."""

    def test_cg_shape_invariant(self, monkeypatch):
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", True)
        from plssvm_sparse_fp22.solver.cg import cg_solve

        b = jnp.ones(8, jnp.float32)
        mask = jnp.ones(4, jnp.float32)  # wrong shape
        with pytest.raises(PLSSVMAssertionError, match="disagree"):
            cg_solve(lambda v: v, b, mask, 1e-3, 10)

    def test_operator_shape_invariant(self, monkeypatch):
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", True)
        from plssvm_sparse_fp22.ops.matvec import build_operator
        from plssvm_sparse_fp22.types import KernelType

        X = jnp.ones((8, 4), jnp.float32)
        with pytest.raises(PLSSVMAssertionError, match="padded system"):
            build_operator(KernelType.linear, X, jnp.zeros(6), jnp.ones(8),
                           0.0, 1.0, mode="linear")

    def test_hybrid_packing_roundtrip(self, monkeypatch):
        """The packing conserves every nonzero: scattering the ELL slab and
        COO tail back reconstructs the CSR exactly (the invariant the
        vacuous in-pack assert could not check)."""
        monkeypatch.setattr(assertions, "ASSERTS_ENABLED", True)
        import scipy.sparse as sp

        from plssvm_sparse_fp22.ops.sparse import HybridSparse

        rng = np.random.default_rng(3)
        csr = sp.random(40, 30, density=0.2, format="csr", random_state=rng,
                        data_rvs=lambda k: rng.normal(size=k))
        h = HybridSparse.from_csr(csr, dtype=np.float64)
        dense = np.zeros((40, 30))
        vals = np.asarray(h.ell.values)
        cols = np.asarray(h.ell.cols)
        for i in range(40):
            for l in range(h.ell.row_capacity):
                dense[i, cols[i, l]] += vals[i, l]
        for r, c, v in zip(np.asarray(h.coo_rows), np.asarray(h.coo_cols),
                           np.asarray(h.coo_vals)):
            dense[r, c] += v
        np.testing.assert_allclose(dense, csr.toarray(), rtol=0, atol=0)
