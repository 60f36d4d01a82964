"""Sparse (CSR/ELL) path tests — the capability extension over the reference.

The reference always densifies sparse input (``parameter.hpp:51-75``); these
tests check that the retained-CSR training/predict paths produce the same
models as the dense paths.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import plssvm_sparse_fp22 as pt
from plssvm_sparse_fp22.io.libsvm import ParsedData
from plssvm_sparse_fp22.io.model import parse_model_file, write_model_file
from plssvm_sparse_fp22.ops.sparse import (
    ELLMatrix,
    ell_matvec,
    ell_rmatvec,
    host_gram_from_csr,
)
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType


def _random_sparse(n, f, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    # ensure no empty rows (every point has at least one feature)
    for i in range(n):
        if csr.indptr[i] == csr.indptr[i + 1]:
            csr[i, rng.integers(f)] = rng.normal()
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return csr, y


class TestELL:
    def test_pack_roundtrip(self):
        csr, _ = _random_sparse(20, 15)
        ell = ELLMatrix.from_csr(csr, dtype=np.float64)
        dense = np.zeros((20, 15))
        v = np.asarray(ell.values)
        c = np.asarray(ell.cols)
        for i in range(20):
            for l in range(ell.row_capacity):
                if v[i, l] != 0:
                    dense[i, c[i, l]] += v[i, l]
        np.testing.assert_allclose(dense, csr.toarray())

    def test_matvec(self):
        csr, _ = _random_sparse(30, 12)
        ell = ELLMatrix.from_csr(csr, dtype=np.float64)
        u = np.random.default_rng(1).normal(size=12)
        np.testing.assert_allclose(
            np.asarray(ell_matvec(ell, jnp.asarray(u))), csr @ u, rtol=1e-12
        )

    def test_rmatvec(self):
        csr, _ = _random_sparse(30, 12)
        ell = ELLMatrix.from_csr(csr, dtype=np.float64)
        v = np.random.default_rng(2).normal(size=30)
        np.testing.assert_allclose(
            np.asarray(ell_rmatvec(ell, jnp.asarray(v))), csr.T @ v, rtol=1e-12
        )

    def test_pad_rows(self):
        csr, _ = _random_sparse(10, 8)
        ell = ELLMatrix.from_csr(csr, dtype=np.float64, pad_rows=16)
        assert ell.values.shape[0] == 16
        u = np.ones(8)
        got = np.asarray(ell_matvec(ell, jnp.asarray(u)))
        np.testing.assert_allclose(got[:10], csr @ u, rtol=1e-12)
        np.testing.assert_array_equal(got[10:], np.zeros(6))

    def test_host_gram(self):
        csr, _ = _random_sparse(25, 40)
        G = host_gram_from_csr(csr, dept=24)
        X = csr.toarray()
        np.testing.assert_allclose(G, X[:24] @ X[:24].T, rtol=1e-12)


def _make_params(csr, y, kernel, sparse: bool, **kw):
    p = Parameter(dtype=np.float64, kernel=kernel, gamma=0.2, coef0=1.0,
                  max_iter=300, epsilon=1e-8,
                  sparse_threshold=1.0 if sparse else -1.0, **kw)
    p.data = ParsedData(csr=csr, values=y)
    p.values = y
    return p


@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.polynomial, KernelType.rbf])
class TestSparseLearnParity:
    def test_sparse_matches_dense(self, kernel):
        csr, y = _random_sparse(60, 25, density=0.15, seed=7)

        svm_d = pt.CSVM(_make_params(csr, y, kernel, sparse=False))
        svm_d.print_info = False
        svm_d.learn()

        svm_s = pt.CSVM(_make_params(csr, y, kernel, sparse=True))
        svm_s.print_info = False
        svm_s.learn()
        assert svm_s.last_cg_info["mode"].startswith("sparse")

        np.testing.assert_allclose(svm_s.alphas, svm_d.alphas, rtol=1e-5, atol=1e-7)
        assert svm_s.bias_ == pytest.approx(svm_d.bias_, rel=1e-5, abs=1e-7)

        # predictions agree on dense query points
        P = np.random.default_rng(9).normal(size=(12, 25))
        np.testing.assert_allclose(
            svm_s.predict(P), svm_d.predict(P), rtol=1e-5, atol=1e-7
        )

    def test_sparse_model_file_equals_dense(self, kernel, tmp_path):
        csr, y = _random_sparse(40, 18, density=0.2, seed=11)
        svm = pt.CSVM(_make_params(csr, y, kernel, sparse=True))
        svm.print_info = False
        svm.learn()

        sparse_path = tmp_path / "s.model"
        svm.write_model(str(sparse_path))

        # writing the same SVs from the densified matrix gives the same bytes
        dense_path = tmp_path / "d.model"
        write_model_file(
            dense_path, kernel=svm.kernel, rho=-svm.bias_, data=csr.toarray(),
            labels=y, alphas=svm.alphas, degree=svm.degree, gamma=svm.gamma,
            coef0=svm.coef0,
        )
        assert sparse_path.read_text() == dense_path.read_text()

        # and it parses back
        m = parse_model_file(str(sparse_path))
        assert m.support_vectors.num_points == 40


@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.rbf])
def test_predict_parsed_sparse_end_to_end(kernel):
    """Sparse SVs x sparse test points: predict without densifying either."""
    csr, y = _random_sparse(50, 20, density=0.15, seed=13)
    svm = pt.CSVM(_make_params(csr, y, kernel, sparse=True))
    svm.print_info = False
    svm.learn()

    test_csr, _ = _random_sparse(15, 20, density=0.15, seed=14)
    parsed = ParsedData(csr=test_csr, values=None)
    out_sparse = svm.predict_parsed(parsed)
    out_dense = svm.predict(test_csr.toarray())
    np.testing.assert_allclose(out_sparse, out_dense, rtol=1e-8, atol=1e-10)
    # accuracy() on sparse training data also avoids densification
    assert 0.0 <= svm.accuracy() <= 1.0


def test_sparse_fixture_trains(reference_data_dir):
    """The 5x4.sparse fixture (density 0.25) takes the sparse path."""
    p = Parameter(dtype=np.float64)
    p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.sparse.libsvm")
    svm = pt.make_csvm(p)
    svm.print_info = False
    svm.learn()
    assert svm.last_cg_info["mode"].startswith("sparse")
    assert svm.accuracy() >= 0.6


class TestDeviceGram:
    """Blockwise device Gram assembly from ELL vs the host SpGEMM oracle."""

    def test_matches_host_gram(self):
        import scipy.sparse as sp

        from plssvm_sparse_fp22.ops.sparse import (
            ELLMatrix,
            device_gram_from_ell,
            host_gram_from_csr,
        )

        csr = sp.random(100, 37, density=0.15, random_state=0, format="csr")
        ell = ELLMatrix.from_csr(csr, dtype=np.float64, pad_rows=128)
        G_dev = np.asarray(device_gram_from_ell(ell))
        G_host = host_gram_from_csr(csr)
        np.testing.assert_allclose(G_dev[:100, :100], G_host, rtol=1e-12)
        # padding rows/cols are exact zeros
        assert not G_dev[100:, :].any() and not G_dev[:, 100:].any()

    def test_any_row_count_works(self):
        """The one-scatter densify has no block-divisibility constraint
        (the removed blockwise assembly required n % row_block == 0)."""
        import scipy.sparse as sp

        from plssvm_sparse_fp22.ops.sparse import ELLMatrix, device_gram_from_ell

        csr = sp.random(10, 5, density=0.5, random_state=1, format="csr")
        ell = ELLMatrix.from_csr(csr, dtype=np.float64)
        G = np.asarray(device_gram_from_ell(ell))
        np.testing.assert_allclose(G, (csr @ csr.T).toarray(), rtol=1e-12)

    @pytest.mark.parametrize("kernel", ["polynomial", "rbf"])
    def test_sparse_learn_device_vs_host_gram(self, kernel, monkeypatch):
        """The full sparse poly/rbf training path gives the same model with
        the device Gram as with the host SpGEMM."""
        import scipy.sparse as sp

        from plssvm_sparse_fp22.params import Parameter
        from plssvm_sparse_fp22.models.factory import make_csvm
        from plssvm_sparse_fp22.types import KernelType

        rng = np.random.default_rng(23)
        X = sp.random(120, 40, density=0.12, random_state=2, format="csr")
        y = np.where(rng.normal(size=120) > 0, 1.0, -1.0)

        def train():
            # f64: the host path assembles the Gram in f64 and casts, the
            # device path assembles in working precision — only equal at f64
            params = Parameter(
                kernel=KernelType.from_string(kernel), gamma=0.1, epsilon=1e-8,
                print_info=False, sparse_threshold=1.0, dtype=np.float64,
            )
            params.data = ParsedData(csr=X, values=y)
            params.values = y
            svm = make_csvm(params)
            svm.learn()
            # decision values are the CG-stable comparison quantity (alphas
            # of an ill-conditioned system amplify last-bit Gram rounding)
            return svm.predict_parsed(svm.data), svm.last_cg_info["mode"]

        monkeypatch.setenv("PLSSVM_DEVICE_GRAM_MAX_FEATURES", "100000")
        d_dev, mode_dev = train()
        monkeypatch.setenv("PLSSVM_DEVICE_GRAM_MAX_FEATURES", "0")
        d_host, mode_host = train()
        assert mode_dev == mode_host == "sparse_gram"
        np.testing.assert_allclose(d_dev, d_host, rtol=1e-4, atol=1e-6)


class TestHybridSparse:
    """ELL+COO hybrid: bounded memory on skewed row fills."""

    def _skewed(self, n=50, f=400, seed=3):
        rng = np.random.default_rng(seed)
        csr = sp.random(n, f, density=0.02, format="lil", random_state=rng,
                        data_rvs=lambda k: rng.normal(size=k))
        csr[7, :] = rng.normal(size=f)  # one dense row
        csr = csr.tocsr()
        csr.eliminate_zeros()
        return csr

    def test_pack_memory_bounded(self):
        from plssvm_sparse_fp22.ops.sparse import HybridSparse

        csr = self._skewed()
        h = HybridSparse.from_csr(csr, dtype=np.float64)
        ell_plain = ELLMatrix.from_csr(csr, dtype=np.float64)
        # plain ELL pads every row to the dense row's length
        assert ell_plain.row_capacity == 400
        # hybrid caps the slab and spills the dense row into the COO tail
        hybrid_cells = h.ell.values.size + 3 * h.coo_vals.size
        assert h.ell.row_capacity < 40
        assert hybrid_cells < ell_plain.values.size / 5

    def test_matvec_parity(self):
        from plssvm_sparse_fp22.ops.sparse import (
            HybridSparse, hybrid_matvec, hybrid_rmatvec, hybrid_row_sqnorms)

        csr = self._skewed()
        h = HybridSparse.from_csr(csr, dtype=np.float64)
        rng = np.random.default_rng(5)
        u = rng.normal(size=csr.shape[1])
        v = rng.normal(size=csr.shape[0])
        np.testing.assert_allclose(
            np.asarray(hybrid_matvec(h, jnp.asarray(u))), csr @ u, rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(hybrid_rmatvec(h, jnp.asarray(v))), csr.T @ v, rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(hybrid_row_sqnorms(h)),
            np.asarray(csr.multiply(csr).sum(axis=1)).ravel(), rtol=1e-12)


class TestStreamingImplicit:
    """The sparse north star: poly/rbf CG without materializing the Gram
    (BASELINE.json config 3)."""

    @pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
    def test_streaming_matches_dense(self, kernel, monkeypatch):
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        csr, y = _random_sparse(300, 25, density=0.15, seed=13)

        svm_s = pt.CSVM(_make_params(csr, y, kernel, sparse=True))
        svm_s.print_info = False
        svm_s.learn()
        assert svm_s.last_cg_info["mode"] == "sparse_implicit"

        monkeypatch.delenv("PLSSVM_SPARSE_MODE")
        svm_d = pt.CSVM(_make_params(csr, y, kernel, sparse=False))
        svm_d.print_info = False
        svm_d.learn()

        np.testing.assert_allclose(svm_s.alphas[:-1], svm_d.alphas[:-1],
                                   rtol=1e-5, atol=1e-7)
        assert svm_s.bias_ == pytest.approx(svm_d.bias_, rel=1e-3, abs=1e-5)
        P = np.random.default_rng(9).normal(size=(12, 25))
        np.testing.assert_allclose(
            svm_s.predict(P), svm_d.predict(P), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("strategy", ["panel", "gather"])
    def test_streaming_strategies_match_dense(self, strategy, monkeypatch):
        """Both streaming contractions (scatter-free densified panels on the
        pair kernel vs ELL-slot gather) reproduce the dense model."""
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        monkeypatch.setenv("PLSSVM_SPARSE_STREAM", strategy)
        csr, y = _random_sparse(200, 30, density=0.12, seed=29)

        svm_s = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
        svm_s.print_info = False
        svm_s.learn()
        assert svm_s.last_cg_info["mode"] == "sparse_implicit"

        monkeypatch.delenv("PLSSVM_SPARSE_MODE")
        svm_d = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=False))
        svm_d.print_info = False
        svm_d.learn()
        np.testing.assert_allclose(svm_s.alphas[:-1], svm_d.alphas[:-1],
                                   rtol=1e-5, atol=1e-7)

    def test_dense_x_middle_tier(self, monkeypatch):
        """Gram too big for the K budget but dense X fits: the sparse learn
        densifies X only (D*f << D^2) and rides the flagship implicit
        kernel instead of the slow streaming tier."""
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "100000")
        csr, y = _random_sparse(200, 30, density=0.12, seed=31)
        svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
        svm.print_info = False
        svm.learn()
        assert svm.last_cg_info["mode"] == "sparse_dense_implicit"

        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
        svm_d = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=False))
        svm_d.print_info = False
        svm_d.learn()
        np.testing.assert_allclose(svm.alphas[:-1], svm_d.alphas[:-1],
                                   rtol=1e-5, atol=1e-7)

    def test_strategy_chooser(self, monkeypatch):
        from plssvm_sparse_fp22.ops.sparse import streaming_stream_strategy

        # moderate density -> densified panels at GEMM rate
        assert streaming_stream_strategy(100, 2048) == "panel"
        # news20-scale extreme sparsity -> nnz-proportional gather
        assert streaming_stream_strategy(30, 1_300_000) == "gather"
        monkeypatch.setenv("PLSSVM_SPARSE_STREAM", "gather")
        assert streaming_stream_strategy(100, 2048) == "gather"
        # a forced panel strategy holds even at extreme sparsity
        monkeypatch.setenv("PLSSVM_SPARSE_STREAM", "panel")
        assert streaming_stream_strategy(30, 1_300_000) == "panel"

    def test_memory_guard_picks_streaming(self, monkeypatch):
        """A Gram too big for the K-cache budget falls back to streaming
        instead of OOMing the host (memory guard)."""
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        csr, y = _random_sparse(80, 20, density=0.2, seed=17)
        svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
        svm.print_info = False
        svm.learn()
        assert svm.last_cg_info["mode"] == "sparse_implicit"

    def test_streaming_jacobi(self, monkeypatch):
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        csr, y = _random_sparse(150, 25, density=0.15, seed=19)
        svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True,
                                   precond="jacobi"))
        svm.print_info = False
        svm.learn()
        assert svm.last_cg_info["mode"] == "sparse_implicit"
        svm_plain = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=False))
        svm_plain.print_info = False
        svm_plain.learn()
        np.testing.assert_allclose(svm.alphas[:-1], svm_plain.alphas[:-1],
                                   rtol=1e-5, atol=1e-6)

    def test_streaming_skewed_rows(self, monkeypatch):
        """Pathological skew (one dense row) trains through the hybrid
        packing within bounded memory."""
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        rng = np.random.default_rng(23)
        n, f = 90, 300
        csr = sp.random(n, f, density=0.03, format="lil", random_state=rng,
                        data_rvs=lambda k: rng.normal(size=k))
        csr[11, :] = rng.normal(size=f)
        csr = csr.tocsr()
        for i in range(n):
            if csr.indptr[i] == csr.indptr[i + 1]:
                csr[i, rng.integers(f)] = rng.normal()
        csr = csr.tocsr()
        y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)

        svm_s = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
        svm_s.print_info = False
        svm_s.learn()
        assert svm_s.last_cg_info["mode"] == "sparse_implicit"
        svm_d = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=False))
        svm_d.print_info = False
        svm_d.learn()
        np.testing.assert_allclose(svm_s.alphas[:-1], svm_d.alphas[:-1],
                                   rtol=1e-5, atol=1e-6)


class TestTiledELL:
    """Lane-tiled ELL packing + scatter-free compare-densify (the panel
    streaming strategy's building blocks)."""

    def test_densify_roundtrip(self):
        from plssvm_sparse_fp22.ops.sparse import TiledELL, densify_tiled

        csr, _ = _random_sparse(40, 300, density=0.08, seed=3)
        tell = TiledELL.from_csr(csr, dtype=np.float64)
        dense = np.asarray(densify_tiled(tell.vals, tell.lcols,
                                         tell.ntiles, tell.Lt))
        fp = tell.padded_features
        expect = np.zeros((40, fp))
        expect[:, :300] = csr.toarray()
        np.testing.assert_allclose(dense, expect, rtol=1e-14)

    def test_densify_pad_rows(self):
        from plssvm_sparse_fp22.ops.sparse import TiledELL, densify_tiled

        csr, _ = _random_sparse(10, 50, density=0.2, seed=5)
        tell = TiledELL.from_csr(csr, dtype=np.float64, pad_rows=16)
        dense = np.asarray(densify_tiled(tell.vals, tell.lcols,
                                         tell.ntiles, tell.Lt))
        np.testing.assert_allclose(dense[:10, :50], csr.toarray(), rtol=1e-14)
        assert not dense[10:].any() and not dense[:, 50:].any()

    def test_tiled_matvec(self):
        from plssvm_sparse_fp22.ops.sparse import TiledELL, tiled_matvec

        csr, _ = _random_sparse(30, 200, density=0.1, seed=7)
        tell = TiledELL.from_csr(csr, dtype=np.float64)
        u = np.random.default_rng(1).normal(size=tell.padded_features)
        got = np.asarray(tiled_matvec(tell.vals, tell.lcols,
                                      jnp.asarray(u), tell.ntiles, tell.Lt))
        np.testing.assert_allclose(got, csr @ u[:200], rtol=1e-12)

    def test_storage_never_exceeds_padded_dense(self):
        from plssvm_sparse_fp22.ops.sparse import TiledELL

        rng = np.random.default_rng(11)
        csr = sp.random(20, 140, density=0.9, format="csr", random_state=rng)
        tell = TiledELL.from_csr(csr, dtype=np.float32)
        assert tell.Lt <= 128
        assert tell.vals.shape[1] <= tell.padded_features

    def test_panel_matvec_matches_dense_gram(self):
        """The multi-panel streaming matvec equals the dense kernel matvec
        — including ragged last panels."""
        from plssvm_sparse_fp22.ops.kernel_functions import gram_matrix
        from plssvm_sparse_fp22.ops.sparse import (TiledELL,
                                                       make_tiled_panel_matvec)

        csr, _ = _random_sparse(100, 60, density=0.15, seed=13)
        tell = TiledELL.from_csr(csr, dtype=np.float64)
        gamma, coef0 = 0.3, 1.0
        for kernel in (KernelType.polynomial, KernelType.rbf):
            for panel_rows in (100, 32, 48):
                mv, sq = make_tiled_panel_matvec(
                    tell.vals, tell.lcols, int(kernel), 3, gamma, coef0,
                    ntiles=tell.ntiles, Lt=tell.Lt, panel_rows=panel_rows)
                v = np.random.default_rng(17).normal(size=100)
                K = np.asarray(gram_matrix(kernel, jnp.asarray(csr.toarray()),
                                           degree=3, gamma=gamma, coef0=coef0))
                np.testing.assert_allclose(np.asarray(mv(jnp.asarray(v))),
                                           K @ v, rtol=1e-9, atol=1e-10)
                np.testing.assert_allclose(
                    np.asarray(sq),
                    np.asarray(csr.multiply(csr).sum(axis=1)).ravel(),
                    rtol=1e-12)

    def test_windowed_matvec_matches_dense_gram(self):
        """The bounded-liveness i-major windowed sweep (scan-based, the
        beyond-HBM schedule) equals the dense kernel matvec — including
        panel counts that do not divide the row count (internal zero-row
        padding) and the single-panel degenerate case."""
        from plssvm_sparse_fp22.ops.kernel_functions import gram_matrix
        from plssvm_sparse_fp22.ops.sparse import (
            TiledELL, make_tiled_panel_matvec_windowed)

        csr, _ = _random_sparse(100, 60, density=0.15, seed=13)
        tell = TiledELL.from_csr(csr, dtype=np.float64)
        gamma, coef0 = 0.3, 1.0
        for kernel in (KernelType.polynomial, KernelType.rbf):
            for panel_rows in (100, 32, 48):
                mv, sq = make_tiled_panel_matvec_windowed(
                    tell.vals, tell.lcols, int(kernel), 3, gamma, coef0,
                    ntiles=tell.ntiles, Lt=tell.Lt, panel_rows=panel_rows)
                v = np.random.default_rng(17).normal(size=100)
                K = np.asarray(gram_matrix(kernel, jnp.asarray(csr.toarray()),
                                           degree=3, gamma=gamma, coef0=coef0))
                np.testing.assert_allclose(np.asarray(mv(jnp.asarray(v))),
                                           K @ v, rtol=1e-9, atol=1e-10)
                np.testing.assert_allclose(
                    np.asarray(sq),
                    np.asarray(csr.multiply(csr).sum(axis=1)).ravel(),
                    rtol=1e-12)

    def test_windowed_matvec_heavy_rows(self):
        """Windowed sweep with a heavy-row spill: traced-position placement
        must land heavy rows in the right panels across panel boundaries."""
        from plssvm_sparse_fp22.ops.kernel_functions import gram_matrix
        from plssvm_sparse_fp22.ops.sparse import (
            TiledHybrid, make_tiled_panel_matvec_windowed)

        rng = np.random.default_rng(31)
        dense_np = np.zeros((96, 70))
        m = rng.random((96, 70)) < 0.1
        dense_np[m] = rng.normal(size=int(m.sum()))
        dense_np[5] = rng.normal(size=70)   # heavy row, first panel
        dense_np[70] = rng.normal(size=70)  # heavy row, later panel
        csr = sp.csr_matrix(dense_np)
        th = TiledHybrid.from_csr(csr, dtype=np.float64)
        assert len(th.heavy_idx) >= 2
        hs = np.zeros(96)
        hs[th.heavy_idx] = (dense_np[th.heavy_idx] ** 2).sum(axis=1)
        mv, sq = make_tiled_panel_matvec_windowed(
            th.tell.vals, th.tell.lcols, int(KernelType.rbf), 3, 0.1, 0.0,
            ntiles=th.tell.ntiles, Lt=th.tell.Lt, panel_rows=32,
            heavy=th.heavy,
            heavy_rows=tuple(int(r) for r in th.heavy_idx),
            heavy_sq_vec=jnp.asarray(hs))
        v = rng.normal(size=96)
        K = np.asarray(gram_matrix(KernelType.rbf, jnp.asarray(dense_np),
                                   degree=3, gamma=0.1, coef0=0.0))
        np.testing.assert_allclose(np.asarray(mv(jnp.asarray(v))), K @ v,
                                   rtol=1e-9, atol=1e-10)


class TestPairGramContrib:
    """The panel-pair product (one GEMM + kernel function per pair) vs the
    oracle's kernel matrix."""

    @pytest.mark.parametrize("same", [True, False])
    @pytest.mark.parametrize("kernel", [KernelType.linear,
                                        KernelType.polynomial,
                                        KernelType.rbf])
    def test_matches_oracle(self, kernel, same):
        from plssvm_sparse_fp22.ops.sparse import pair_gram_contrib
        from plssvm_sparse_fp22.utils import oracle

        rng = np.random.default_rng(19)
        Di, Dj, f = 24, 24 if same else 40, 33
        Xi = rng.normal(size=(Di, f))
        Xj = Xi if same else rng.normal(size=(Dj, f))
        vi = rng.normal(size=Di)
        vj = vi if same else rng.normal(size=Dj)
        hyper = dict(degree=3, gamma=0.2, coef0=1.0)
        Xi_d = jnp.asarray(Xi)
        oi, oj = pair_gram_contrib(
            kernel, Xi_d, Xi_d if same else jnp.asarray(Xj), jnp.asarray(vi),
            jnp.asarray(vj), same=same, **hyper)
        K = oracle.kernel_matrix(kernel, Xi, Xj, **hyper)
        np.testing.assert_allclose(np.asarray(oi), K @ vj, rtol=1e-10,
                                   atol=1e-12)
        # a diagonal pair carries its whole product in out_i
        want_j = np.zeros(Dj) if same else K.T @ vi
        np.testing.assert_allclose(np.asarray(oj), want_j, rtol=1e-10,
                                   atol=1e-12)

    def test_panel_learn_adaptive_plan_matches_fixed(self):
        """The panel learn's two-tier plan (fast/accurate dot tiers on the
        panel-pair products) converges to the fixed-tier solution."""
        from plssvm_sparse_fp22.models.sparse_learn import (
            learn_sparse_panel_jit)
        from plssvm_sparse_fp22.ops.sparse import TiledELL

        csr, y = _random_sparse(80, 40, density=0.15, seed=23)
        dept = 79
        D = 80
        tell = TiledELL.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
        x_last = np.asarray(csr[-1].todense()).ravel()
        b = np.zeros(D)
        b[:dept] = y[:dept] - y[-1]
        mask = np.zeros(D)
        mask[:dept] = 1.0
        common = dict(kernel=KernelType.rbf, degree=3, ntiles=tell.ntiles,
                      Lt=tell.Lt, panel_rows=32)
        args = (tell.vals, tell.lcols, jnp.asarray(x_last), jnp.asarray(b),
                jnp.asarray(mask), jnp.asarray(0.25), jnp.asarray(0.0),
                jnp.asarray(1.0), jnp.asarray(1e-8), jnp.asarray(200))
        out_x = learn_sparse_panel_jit(*args, **common)
        out_a = learn_sparse_panel_jit(*args, precision_plan=("default", "highest"),
                                       **common)
        assert len(out_a) == 8  # the fast-iteration count rides along
        np.testing.assert_allclose(np.asarray(out_a[0]), np.asarray(out_x[0]),
                                   rtol=1e-6, atol=1e-8)


class TestTiledHybridSkew:
    """Skew robustness of the panel packing (review finding r4): one dense
    row must not inflate Lt to the tile width — it spills to the dense
    heavy-row block instead, keeping memory nnz-proportional."""

    def test_pack_memory_bounded(self):
        from plssvm_sparse_fp22.ops.sparse import TiledELL, TiledHybrid

        rng = np.random.default_rng(3)
        csr = sp.random(2000, 1024, density=0.02, format="lil",
                        random_state=rng)
        csr[7, :] = rng.normal(size=1024)
        csr = csr.tocsr()
        csr.eliminate_zeros()
        th = TiledHybrid.from_csr(csr, dtype=np.float64)
        raw = TiledELL.from_csr(csr, dtype=np.float64)
        dense_cells = 2000 * th.tell.padded_features
        assert raw.Lt == 128  # the uncapped packing blows up...
        assert th.tell.Lt < 16  # ...the hybrid cap does not
        assert 7 in th.heavy_idx
        assert th.cells < dense_cells // 5

    def test_heavy_rows_learn_parity(self, monkeypatch):
        """Single-chip panel learn with heavy rows matches the dense model
        (multi-panel, so heavy placement crosses panel boundaries)."""
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        rng = np.random.default_rng(31)
        n, f = 520, 600
        csr = sp.random(n, f, density=0.03, format="lil", random_state=rng,
                        data_rvs=lambda k: rng.normal(size=k))
        for r in (11, 250, 400):
            csr[r, :] = rng.normal(size=f)
        csr = csr.tocsr()
        for i in range(n):
            if csr.indptr[i] == csr.indptr[i + 1]:
                csr[i, rng.integers(f)] = rng.normal()
        csr = csr.tocsr()
        y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
        # small budget: multiple panels
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "5000000")
        svm_s = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
        svm_s.print_info = False
        svm_s.learn()
        assert svm_s.last_cg_info["mode"] == "sparse_implicit"
        monkeypatch.delenv("PLSSVM_SPARSE_MODE")
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
        svm_d = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=False))
        svm_d.print_info = False
        svm_d.learn()
        np.testing.assert_allclose(svm_s.alphas[:-1], svm_d.alphas[:-1],
                                   rtol=1e-5, atol=1e-6)

    def test_dense_ish_data_falls_back_to_gather(self, monkeypatch):
        """Data too dense for the tiled packing (packed bytes >= half the
        padded-dense bytes) routes to the memory-safe gather arm."""
        rng = np.random.default_rng(5)
        csr = sp.random(96, 256, density=0.9, format="csr", random_state=rng,
                        data_rvs=lambda k: rng.normal(size=k))
        y = np.where(rng.normal(size=96) > 0, 1.0, -1.0)
        svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
        # the selection policy itself must refuse the panel strategy...
        assert svm._plan_sparse_panel(csr, 95, 96) is None
        # ...and the learn still runs (gather arm)
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        svm.print_info = False
        svm.learn()
        assert svm.last_cg_info["mode"] == "sparse_implicit"


def test_plan_sparse_panel_policy():
    """The shared panel-selection policy: moderate density plans a panel
    learn; extreme sparsity (gather regime) and dense-ish packings return
    None (one policy for the single-chip and ring learns)."""
    from plssvm_sparse_fp22.models.base import CSVM

    csr, y = _random_sparse(128, 64, density=0.1, seed=61)
    svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
    plan = svm._plan_sparse_panel(csr, 127, 128)
    assert plan is not None
    th, sweep = plan
    assert th.tell.vals.shape[0] == 128
    assert sweep == "unrolled"  # in-memory: the fast schedule

    # extreme sparsity: mean fill * 1024 < f -> gather regime, no plan
    wide, yw = _random_sparse(64, 200_000, density=0.00001, seed=63)
    svm_w = pt.CSVM(_make_params(wide, yw, KernelType.rbf, sparse=True))
    assert svm_w._plan_sparse_panel(wide, 63, 64) is None


def test_sparse_tier_guards_respect_physical_memory(monkeypatch):
    """The gram / densify-X tiers are gated on the PHYSICAL working set,
    not just the cache budget: a dense X that fits the budget but whose
    X + transients working set exceeds the device must stream instead
    (an 8.6 GB dense X once passed the 8 GiB budget check and ran out of
    a 16 GB device's memory)."""
    from plssvm_sparse_fp22.models.base import CSVM

    csr, y = _random_sparse(256, 64, density=0.1, seed=67)
    svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
    svm.print_info = False
    D = 256  # padded rows; padded features 128
    dense_bytes = D * 64 * 8  # f64 under x64 tests
    # physical memory passes the packing guards but fails 2.5x dense and
    # 2x gram -> both cached tiers refuse, the learn streams
    monkeypatch.setattr(CSVM, "_device_memory_bytes",
                        staticmethod(lambda: 2 * dense_bytes))
    svm.learn()
    assert svm.last_cg_info["mode"] == "sparse_implicit", svm.last_cg_info


def test_plan_sparse_panel_beyond_memory_goes_windowed(monkeypatch):
    """When the unrolled sweep's ~4x-dense envelope exceeds physical
    memory, the plan switches to the bounded-liveness windowed sweep
    instead of refusing (the physically-beyond-memory
    single-chip regime gets a panel-class answer).  Only when even the
    resident packing cannot fit does the plan return None (gather arm)."""
    from plssvm_sparse_fp22.models.base import CSVM

    csr, y = _random_sparse(128, 64, density=0.1, seed=61)
    svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
    dense_bytes = 128 * 128 * 4  # padded fp = 128

    # physical memory just under the unrolled envelope -> windowed
    monkeypatch.setattr(CSVM, "_device_memory_bytes",
                        staticmethod(lambda: 4 * dense_bytes - 1))
    plan = svm._plan_sparse_panel(csr, 127, 128)
    assert plan is not None and plan[1] == "windowed"

    # physical memory below even the packing -> gather arm
    monkeypatch.setattr(CSVM, "_device_memory_bytes",
                        staticmethod(lambda: 1024))
    assert svm._plan_sparse_panel(csr, 127, 128) is None

    # ring planning scales the envelope per shard:
    # a per-chip memory that refuses ndev=1 admits the 8-way ring
    monkeypatch.setattr(CSVM, "_device_memory_bytes",
                        staticmethod(lambda: 4 * dense_bytes // 2))
    ring = svm._plan_sparse_panel(csr, 127, 128, ndev=8)
    assert ring is not None and ring[1] == "unrolled"


@pytest.mark.parametrize("pairs,dense,physical,forced,want", [
    (1, None, None, None, "unrolled"),
    (16, None, None, None, "unrolled"),          # at the cap
    (17, None, None, None, "windowed"),          # past the cap
    (2080, None, None, None, "windowed"),        # 64 panels
    (3, 100, 400, None, "unrolled"),             # envelope fits
    (3, 100, 399, None, "windowed"),             # envelope exceeds memory
    (1, 100, 399, None, "windowed"),             # even for one panel
    (2080, None, None, "unrolled", "unrolled"),  # forced
    (1, None, None, "windowed", "windowed"),
])
def test_panel_sweep_strategy(monkeypatch, pairs, dense, physical, forced,
                              want):
    """The sweep goes windowed past the traced-pair cap or the unrolled
    memory envelope; PLSSVM_SPARSE_PANEL_SWEEP overrides both."""
    from plssvm_sparse_fp22.ops.sparse import (MAX_UNROLLED_PAIRS,
                                               panel_sweep_strategy)

    assert MAX_UNROLLED_PAIRS == 16
    if forced:
        monkeypatch.setenv("PLSSVM_SPARSE_PANEL_SWEEP", forced)
    else:
        monkeypatch.delenv("PLSSVM_SPARSE_PANEL_SWEEP", raising=False)
    assert panel_sweep_strategy(pairs, dense, physical) == want


@pytest.mark.parametrize("budget,ndev,want", [
    (None, 1, "unrolled"),   # one panel
    (None, 2, "unrolled"),
    (1000, 1, "windowed"),   # 10 panels of 256 rows: 55 pairs
    (1000, 2, "windowed"),   # 5 panels per shard: 25 hop products
    (1000, 5, "unrolled"),   # 2 panels per shard: 4 hop products
])
def test_plan_sparse_panel_caps_traced_pairs(monkeypatch, budget, ndev, want):
    """The plan counts the pairs its sweep would trace (nP(nP+1)/2 on one
    device, nP^2 per ring hop) and goes windowed past the cap."""
    from plssvm_sparse_fp22.models.base import CSVM

    monkeypatch.delenv("PLSSVM_SPARSE_PANEL_SWEEP", raising=False)
    if budget is None:
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES", raising=False)
    else:
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", str(budget))
    monkeypatch.setattr(CSVM, "_device_memory_bytes",
                        staticmethod(lambda: 1 << 40))
    csr, y = _random_sparse(2560, 64, density=0.1, seed=71)
    svm = pt.CSVM(_make_params(csr, y, KernelType.rbf, sparse=True))
    plan = svm._plan_sparse_panel(csr, 2559, 2560, ndev=ndev)
    assert plan is not None and plan[1] == want


@pytest.mark.parametrize("shapes", [
    (8, 8, 5),       # tiny, far below one block
    (100, 36, 129),  # f just over one lane tile
    (257, 64, 200),  # ragged rows both sides
    (64, 512, 64),   # j side much larger than i side
])
def test_pair_gram_contrib_shape_fuzz(shapes):
    """The panel-pair product handles arbitrary panel shapes (vs the
    oracle's cross kernel matrix, both directions)."""
    from plssvm_sparse_fp22.ops.sparse import pair_gram_contrib
    from plssvm_sparse_fp22.utils import oracle

    Di, Dj, f = shapes
    rng = np.random.default_rng(Di + Dj + f)
    Xi = rng.normal(size=(Di, f))
    Xj = rng.normal(size=(Dj, f))
    vi = rng.normal(size=Di)
    vj = rng.normal(size=Dj)
    hyper = dict(degree=3, gamma=0.05, coef0=1.0)
    oi, oj = pair_gram_contrib(KernelType.rbf, jnp.asarray(Xi),
                               jnp.asarray(Xj), jnp.asarray(vi),
                               jnp.asarray(vj), same=False, **hyper)
    K = oracle.kernel_matrix(KernelType.rbf, Xi, Xj, **hyper)
    np.testing.assert_allclose(np.asarray(oi), K @ vj, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(oj), K.T @ vi, rtol=1e-9,
                               atol=1e-11)
