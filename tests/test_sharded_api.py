"""Product-surface multi-chip tests: ``CSVM.learn()``/``predict()`` and the
CLI transparently use every visible device (8 virtual CPU devices here).

The reference's ``learn()`` transparently spans all GPUs
(``gpu_csvm.cpp:130-157``); these tests pin that behavior for this build:
zero new flags, oracle-parity results, and feature-flag parity (checkpoint /
jacobi / verbose) across the single-chip, sharded, and sparse learn paths.
"""

import os

import numpy as np
import pytest

from plssvm_sparse_fp22.cli.predict import main as predict_main
from plssvm_sparse_fp22.cli.train import main as train_main
from plssvm_sparse_fp22.io.model import parse_model_file
from plssvm_sparse_fp22.models import make_csvm
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType
from plssvm_sparse_fp22.utils import oracle

from utils import make_blobs

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.1, "coef0": 1.0}
# dept >= 1024 so the rows-per-shard cap admits all 8 virtual devices
N, F = 1100, 16


def _write_libsvm(path, X, y):
    with open(path, "w") as fh:
        for xi, yi in zip(X, y):
            feats = " ".join(f"{j + 1}:{v:.10g}" for j, v in enumerate(xi))
            fh.write(f"{int(yi)} {feats}\n")


def _train(X, y, kernel, **overrides):
    params = Parameter(kernel=kernel, cost=2.0, epsilon=1e-10, max_iter=300,
                       print_info=False, dtype=np.float64, **HYPER)
    for k, v in overrides.items():
        setattr(params, k, v)
    from plssvm_sparse_fp22.io.libsvm import ParsedData
    import scipy.sparse as sp

    params.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    params.values = y
    svm = make_csvm(params)
    svm.learn()
    return svm



def _assert_matches(alphas, bias, alpha_ref, bias_ref, tol=1e-4, sum_tol=5e-3):
    """Per-alpha parity at CG-trajectory tolerance; alpha_last = -sum(x) and
    the bias amplify per-element noise by O(n), so they get a wider budget
    (same rationale as the reference's blocked-summation-aware compares,
    ``tests/backends/compare.cpp:34-48``)."""
    np.testing.assert_allclose(alphas[:-1], alpha_ref[:-1], rtol=tol, atol=tol)
    assert alphas[-1] == pytest.approx(alpha_ref[-1], rel=sum_tol, abs=sum_tol)
    assert bias == pytest.approx(bias_ref, rel=sum_tol, abs=sum_tol)

@pytest.fixture(scope="module")
def blobs():
    return make_blobs(N, F, seed=11)


@pytest.fixture(scope="module")
def oracle_solutions(blobs):
    X, y = blobs
    return {
        kernel: oracle.solve_lssvm(
            X, y, kernel=kernel, cost=2.0, epsilon=1e-10, max_iter=300, **HYPER
        )
        for kernel in KERNELS
    }


@pytest.mark.parametrize("kernel", KERNELS)
def test_csvm_learn_auto_sharded_matches_oracle(kernel, blobs, oracle_solutions):
    """Zero new flags: ``learn()`` on an 8-device mesh row-shards
    transparently and matches the numpy oracle."""
    X, y = blobs
    svm = _train(X, y, kernel)
    assert svm.last_cg_info["mode"].startswith("sharded_"), svm.last_cg_info
    assert svm.last_cg_info["mode"].endswith("[8]")
    alpha_ref, bias_ref, _ = oracle_solutions[kernel]
    _assert_matches(svm.alphas, svm.bias_, alpha_ref, bias_ref)


@pytest.mark.parametrize("kernel", KERNELS)
def test_csvm_devices_pin_single_chip(kernel, blobs):
    """``Parameter(devices=1)`` pins the single-chip path; results agree
    with the auto-sharded run."""
    X, y = blobs
    svm1 = _train(X, y, kernel, devices=1)
    assert not svm1.last_cg_info["mode"].startswith("sharded_")
    svm8 = _train(X, y, kernel)
    _assert_matches(svm1.alphas, svm1.bias_, svm8.alphas, svm8.bias_)


def test_env_devices_override(blobs, monkeypatch):
    X, y = blobs
    monkeypatch.setenv("PLSSVM_DEVICES", "2")
    svm = _train(X, y, KernelType.rbf)
    assert svm.last_cg_info["mode"].endswith("[2]")


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_predict_matches_oracle_decision(kernel, blobs):
    """Multi-chip predict (SV axis sharded + psum) agrees with the oracle
    decision function on held-out points."""
    X, y = blobs
    svm = _train(X, y, kernel)
    P, _ = make_blobs(64, F, seed=99)
    got = svm.predict(P)
    want = oracle.predict_values(X, svm.alphas, svm.bias_, P, kernel=kernel,
                                 **HYPER)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flags", ["jacobi", "checkpoint", "verbose"])
def test_sharded_feature_flags(flags, blobs, oracle_solutions, tmp_path, capsys):
    """checkpoint / jacobi / verbose_cg work on the sharded learn path with
    the same semantics as single-chip (one CG everywhere)."""
    X, y = blobs
    overrides = {}
    if flags == "jacobi":
        overrides["precond"] = "jacobi"
    elif flags == "checkpoint":
        overrides["checkpoint_path"] = str(tmp_path / "cg.npz")
        overrides["checkpoint_interval"] = 20
    else:
        overrides["verbose_cg"] = True
        overrides["print_info"] = True
    svm = _train(X, y, KernelType.rbf, **overrides)
    assert svm.last_cg_info["mode"].startswith("sharded_")
    alpha_ref, bias_ref, _ = oracle_solutions[KernelType.rbf]
    _assert_matches(svm.alphas, svm.bias_, alpha_ref, bias_ref)
    if flags == "checkpoint":
        assert os.path.exists(overrides["checkpoint_path"])
    if flags == "verbose":
        assert "Start Iteration" in capsys.readouterr().out


def test_sharded_checkpoint_resume(blobs, tmp_path):
    """A sharded learn interrupted by max_iter resumes from the checkpoint
    and finishes with the same solution as an uninterrupted run."""
    X, y = blobs
    ck = str(tmp_path / "resume.npz")
    # phase 1: stop early (max_iter 10 < convergence)
    svm_a = _train(X, y, KernelType.rbf, checkpoint_path=ck, max_iter=10,
                   checkpoint_interval=5)
    assert os.path.exists(ck)
    # phase 2: resume to convergence
    svm_b = _train(X, y, KernelType.rbf, checkpoint_path=ck, max_iter=300,
                   checkpoint_interval=5)
    svm_plain = _train(X, y, KernelType.rbf)
    _assert_matches(svm_b.alphas, svm_b.bias_, svm_plain.alphas, svm_plain.bias_)


@pytest.mark.parametrize("path", ["dense1", "sparse"])
def test_jacobi_parity_other_paths(path, blobs, oracle_solutions):
    """precond=jacobi reaches the same solution on the single-chip dense and
    sparse learn paths (same stopping criterion, fewer/equal iterations)."""
    X, y = blobs
    overrides = {"precond": "jacobi"}
    if path == "dense1":
        overrides["devices"] = 1
    else:
        # force the CSR path AND one device — on a mesh, in-budget sparse
        # rbf densifies onto the sharded dense path and would not exercise
        # the sparse tiers at all
        overrides["sparse_threshold"] = 1.0
        overrides["devices"] = 1
    svm = _train(X, y, KernelType.rbf, **overrides)
    if path == "sparse":
        assert svm.last_cg_info["mode"].startswith("sparse_"), svm.last_cg_info
    alpha_ref, bias_ref, _ = oracle_solutions[KernelType.rbf]
    _assert_matches(svm.alphas, svm.bias_, alpha_ref, bias_ref)


def test_sparse_checkpoint_raises_loudly(blobs, tmp_path):
    """Paths that genuinely cannot checkpoint refuse loudly (single-chip
    sparse); sparse rbf *within the memory budget on a mesh* densifies onto
    the sharded dense path and therefore checkpoints fine."""
    from plssvm_sparse_fp22.exceptions import PLSSVMError

    X, y = blobs
    with pytest.raises(PLSSVMError, match="sparse"):
        _train(X, y, KernelType.rbf, sparse_threshold=1.0, devices=1,
               checkpoint_path=str(tmp_path / "x.npz"))

    svm = _train(X, y, KernelType.rbf, sparse_threshold=1.0,
                 checkpoint_path=str(tmp_path / "ok.npz"))
    assert svm.last_cg_info["mode"].startswith("sharded_")


def test_cli_train_sharded_parity(tmp_path, blobs):
    """``plssvm-train`` on the 8-device mesh (no new flags) produces a model
    whose predictions match a single-device train of the same data."""
    X, y = blobs
    train_file = str(tmp_path / "data.libsvm")
    _write_libsvm(train_file, X, y)

    model8 = str(tmp_path / "m8.model")
    rc = train_main(["-t", "2", "-g", "0.1", "-c", "2.0", "-e", "1e-10",
                     "--max_iter", "300", "-q", train_file, model8])
    assert rc == 0

    model1 = str(tmp_path / "m1.model")
    os.environ["PLSSVM_DEVICES"] = "1"
    try:
        rc = train_main(["-t", "2", "-g", "0.1", "-c", "2.0", "-e", "1e-10",
                         "--max_iter", "300", "-q", train_file, model1])
    finally:
        del os.environ["PLSSVM_DEVICES"]
    assert rc == 0

    m8, m1 = parse_model_file(model8), parse_model_file(model1)
    assert m8.rho == pytest.approx(m1.rho, rel=1e-3, abs=1e-3)
    np.testing.assert_allclose(m8.support_vectors.values,
                               m1.support_vectors.values, rtol=1e-3, atol=1e-3)

    # and predict through the CLI from the sharded-trained model
    pred8 = str(tmp_path / "p8.predict")
    rc = predict_main(["-q", train_file, model8, pred8])
    assert rc == 0
    labels = np.loadtxt(pred8)
    assert np.mean(labels == y) > 0.9


# ---------------------------------------------------------------------------
# sparse data on a multi-chip mesh (transparent, zero flags)
# ---------------------------------------------------------------------------

def _random_sparse(n, f, density=0.15, seed=0):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    csr = sp.random(n, f, density=density, format="csr", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k))
    for i in range(n):
        if csr.indptr[i] == csr.indptr[i + 1]:
            csr[i, rng.integers(f)] = rng.normal()
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return csr, y


def _train_sparse(csr, y, kernel, **overrides):
    params = Parameter(kernel=kernel, cost=2.0, epsilon=1e-10, max_iter=300,
                       print_info=False, dtype=np.float64,
                       sparse_threshold=1.0, **HYPER)
    for k, v in overrides.items():
        setattr(params, k, v)
    from plssvm_sparse_fp22.io.libsvm import ParsedData

    params.data = ParsedData(csr=csr, values=y)
    params.values = y
    svm = make_csvm(params)
    svm.learn()
    return svm


@pytest.fixture(scope="module")
def sparse_blobs():
    return _random_sparse(N, 40, density=0.15, seed=41)


@pytest.fixture(scope="module")
def sparse_blobs_small():
    """Small enough that the ring streaming program (O(n^2 L / p) per CG
    iteration) cannot starve the 8 virtual devices sharing this host's
    cores past XLA's 40 s collective-rendezvous timeout."""
    return _random_sparse(520, 40, density=0.15, seed=43)


class TestSparseSharded:
    def test_sparse_linear_spans_mesh(self, sparse_blobs):
        """Linear CSR data row-shards over all 8 devices (ELL+COO shards,
        psummed feature-space product) and matches the dense result."""
        csr, y = sparse_blobs
        svm_s = _train_sparse(csr, y, KernelType.linear)
        assert svm_s.last_cg_info["mode"] == "sharded_sparse_linear[8]", \
            svm_s.last_cg_info
        svm_d = _train(csr.toarray(), y, KernelType.linear, devices=1)
        _assert_matches(svm_s.alphas, svm_s.bias_, svm_d.alphas, svm_d.bias_)

    def test_sparse_linear_sharded_jacobi(self, sparse_blobs):
        csr, y = sparse_blobs
        svm = _train_sparse(csr, y, KernelType.linear, precond="jacobi")
        assert svm.last_cg_info["mode"] == "sharded_sparse_linear[8]"
        svm_d = _train(csr.toarray(), y, KernelType.linear, devices=1)
        _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)

    def test_sparse_rbf_densifies_onto_mesh(self, sparse_blobs):
        """poly/rbf sparse data within the memory budget densifies and uses
        the sharded dense path (every chip), not the single-chip tier."""
        csr, y = sparse_blobs
        svm = _train_sparse(csr, y, KernelType.rbf)
        assert svm.last_cg_info["mode"].startswith("sharded_")
        assert svm.last_cg_info["mode"].endswith("[8]")
        svm_d = _train(csr.toarray(), y, KernelType.rbf, devices=1)
        _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)

    @pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
    def test_sparse_beyond_budget_rings_the_mesh(self, sparse_blobs_small,
                                                 monkeypatch, kernel):
        """When even dense X exceeds the budget, poly/rbf sparse data walks
        the ring: every chip holds only its ELL+COO shard (the
        HBM-exceeding regime, BASELINE.json config 5) — and the result
        still matches the dense single-chip model."""
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        csr, y = sparse_blobs_small
        svm = _train_sparse(csr, y, kernel)
        assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", \
            svm.last_cg_info
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
        svm_d = _train(csr.toarray(), y, kernel, devices=1)
        _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)

    def test_sparse_beyond_budget_ring_jacobi(self, sparse_blobs_small,
                                              monkeypatch):
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        csr, y = sparse_blobs_small
        svm = _train_sparse(csr, y, KernelType.rbf, precond="jacobi")
        assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]"
        monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
        svm_d = _train(csr.toarray(), y, KernelType.rbf, devices=1)
        _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)

    def test_sparse_forced_tier_pins_single_chip(self, sparse_blobs,
                                                 monkeypatch):
        """A forced PLSSVM_SPARSE_MODE keeps the single-chip tier even on a
        mesh (the env knob pins the exact execution strategy)."""
        monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "1000")
        monkeypatch.setenv("PLSSVM_SPARSE_MODE", "implicit")
        csr, y = sparse_blobs
        svm = _train_sparse(csr, y, KernelType.rbf, max_iter=25)
        assert svm.last_cg_info["mode"] == "sparse_implicit"


def test_wide_sparse_on_mesh_picks_gram_tier(monkeypatch):
    """Wide data (f >> n) on a mesh: dense X is out of budget but the
    (D, D) Gram fits — the learn routes to the one-time-Gram cached tier
    instead of per-iteration ring streaming (orders of magnitude cheaper
    per CG iteration in this regime)."""
    # D pads to 1024 (<=4 shards admitted by the rows cap); budget sits
    # between gram (D^2*8 = 8.4 MB) and dense-per-mesh (D*f*8/ndev = 16.8 MB)
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "10000000")
    csr, y = _random_sparse(520, 8192, density=0.005, seed=47)
    svm = _train_sparse(csr, y, KernelType.rbf, max_iter=40)
    assert svm.last_cg_info["mode"] == "sparse_gram", svm.last_cg_info


class TestFeatureShardedProduct:
    """Wide-dense data (f/p > D) feature-shards through the product surface
    with zero new flags (the reference's own multi-GPU
    decomposition, gpu_csvm.cpp:130-157)."""

    @pytest.fixture(scope="class")
    def wide_blobs(self):
        return make_blobs(96, 2048, seed=31)

    @pytest.mark.parametrize("kernel", KERNELS)
    def test_wide_dense_feature_shards(self, wide_blobs, kernel):
        X, y = wide_blobs
        # gamma = 1/f: at f=2048 the fixture's 0.1 would cube dot products
        # of ~200 (poly QA ~ 1e7), amplifying benign reduction noise in
        # sum(x) into the bias; 1/f is also the parser's auto default
        svm = _train(X, y, kernel, gamma=1.0 / 2048)
        assert svm.last_cg_info["mode"] == "sharded_feature[8]", \
            svm.last_cg_info
        svm_1 = _train(X, y, kernel, devices=1, gamma=1.0 / 2048)
        _assert_matches(svm.alphas, svm.bias_, svm_1.alphas, svm_1.bias_)

    def test_feature_sharded_jacobi(self, wide_blobs):
        X, y = wide_blobs
        svm = _train(X, y, KernelType.rbf, precond="jacobi")
        assert svm.last_cg_info["mode"] == "sharded_feature[8]"
        svm_1 = _train(X, y, KernelType.rbf, devices=1)
        _assert_matches(svm.alphas, svm.bias_, svm_1.alphas, svm_1.bias_)

    def test_axis_override_rows(self, wide_blobs, monkeypatch):
        monkeypatch.setenv("PLSSVM_SHARD_AXIS", "rows")
        X, y = wide_blobs
        svm = _train(X, y, KernelType.linear)
        assert not svm.last_cg_info["mode"].startswith("sharded_feature")

    def test_axis_override_features_on_tall(self, blobs, monkeypatch):
        monkeypatch.setenv("PLSSVM_SHARD_AXIS", "features")
        X, y = blobs  # tall data would normally row-shard
        svm = _train(X, y, KernelType.rbf)
        assert svm.last_cg_info["mode"] == "sharded_feature[8]"
        svm_1 = _train(X, y, KernelType.rbf, devices=1)
        _assert_matches(svm.alphas, svm.bias_, svm_1.alphas, svm_1.bias_)

    def test_invalid_axis_is_loud(self, wide_blobs, monkeypatch):
        from plssvm_sparse_fp22.exceptions import PLSSVMError

        monkeypatch.setenv("PLSSVM_SHARD_AXIS", "bogus")
        X, y = wide_blobs
        with pytest.raises(PLSSVMError, match="PLSSVM_SHARD_AXIS"):
            _train(X, y, KernelType.linear)

    def test_tall_data_stays_on_rows(self, blobs):
        X, y = blobs
        svm = _train(X, y, KernelType.rbf)
        assert svm.last_cg_info["mode"].startswith("sharded_")
        assert not svm.last_cg_info["mode"].startswith("sharded_feature")

    @pytest.mark.parametrize("flags", ["checkpoint", "verbose"])
    def test_feature_sharded_chunked_cg(self, flags, wide_blobs, tmp_path,
                                        capsys):
        """checkpoint / verbose_cg on the FEATURE-sharded path (the
        reference has per-iteration output on every path,
        gpu_csvm.cpp:245-247) — same results as the plain feature learn."""
        X, y = wide_blobs
        overrides = {"gamma": 1.0 / 2048}
        if flags == "checkpoint":
            overrides["checkpoint_path"] = str(tmp_path / "fcg.npz")
            overrides["checkpoint_interval"] = 20
        else:
            overrides["verbose_cg"] = True
            overrides["print_info"] = True
        svm = _train(X, y, KernelType.rbf, **overrides)
        assert svm.last_cg_info["mode"] == "sharded_feature[8]", \
            svm.last_cg_info
        svm_ref = _train(X, y, KernelType.rbf, gamma=1.0 / 2048)
        _assert_matches(svm.alphas, svm.bias_, svm_ref.alphas, svm_ref.bias_)
        if flags == "checkpoint":
            assert os.path.exists(overrides["checkpoint_path"])
        else:
            assert "Start Iteration 1" in capsys.readouterr().out

    def test_feature_sharded_checkpoint_resume(self, wide_blobs, tmp_path):
        """Interrupt a feature-sharded learn at max_iter, resume from its
        checkpoint, converge — the replicated CGState round-trips."""
        X, y = wide_blobs
        ck = str(tmp_path / "fresume.npz")
        svm_a = _train(X, y, KernelType.rbf, gamma=1.0 / 2048,
                       checkpoint_path=ck, max_iter=5, checkpoint_interval=2)
        assert svm_a.last_cg_info["iterations"] == 5
        svm_b = _train(X, y, KernelType.rbf, gamma=1.0 / 2048,
                       checkpoint_path=ck, max_iter=300,
                       checkpoint_interval=2)
        assert svm_b.last_cg_info["mode"] == "sharded_feature[8]"
        svm_ref = _train(X, y, KernelType.rbf, gamma=1.0 / 2048)
        _assert_matches(svm_b.alphas, svm_b.bias_, svm_ref.alphas,
                        svm_ref.bias_)


def test_sparse_ring_multi_panel_in_shard(monkeypatch):
    """A budget smaller than a shard's dense block forces the panel ring to
    decompose each hop into multiple in-shard panels (2 panels of 256 rows
    here) — result still matches the dense single-chip model."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "120000")
    csr, y = _random_sparse(1100, 40, density=0.15, seed=53)
    svm = _train_sparse(csr, y, KernelType.rbf, devices=4, max_iter=300)
    assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", \
        svm.last_cg_info
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    svm_d = _train(csr.toarray(), y, KernelType.rbf, devices=1)
    _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)


def test_sparse_ring_with_heavy_rows(monkeypatch):
    """The panel ring carries skewed rows as a dense heavy-row spill that
    rides the ring alongside the tiled slabs — parity with the dense
    single-chip model."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "100000")
    rng = np.random.default_rng(59)
    n, f = 1100, 300
    csr = _random_sparse(n, f, density=0.05, seed=59)[0].tolil()
    for r in (3, 540, 1050):  # heavy rows on different shards
        csr[r, :] = rng.normal(size=f)
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    svm = _train_sparse(csr, y, KernelType.rbf, devices=4, max_iter=300)
    assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", \
        svm.last_cg_info
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    svm_d = _train(csr.toarray(), y, KernelType.rbf, devices=1)
    _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)


@pytest.mark.parametrize("kernel", [KernelType.polynomial, KernelType.rbf])
@pytest.mark.parametrize("heavy", [False, True])
def test_sparse_ring_windowed_sweep(monkeypatch, kernel, heavy):
    """The scanned hop sweep of the panel ring (uniform panels, the shard
    padded to a panel multiple, heavy rows placed at traced positions)
    matches the dense single-chip model, as the unrolled sweep does."""
    monkeypatch.setenv("PLSSVM_K_CACHE_BYTES", "100000")
    monkeypatch.setenv("PLSSVM_SPARSE_PANEL_SWEEP", "windowed")
    rng = np.random.default_rng(61)
    n, f = 1100, 300
    csr = _random_sparse(n, f, density=0.05, seed=61)[0].tolil()
    if heavy:
        for r in (3, 300, 540, 1050):  # heavy rows on different shards
            csr[r, :] = rng.normal(size=f)
    csr = csr.tocsr()
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    svm = _train_sparse(csr, y, kernel, devices=4, max_iter=300)
    assert svm.last_cg_info["mode"] == "sharded_sparse_implicit[4]", \
        svm.last_cg_info
    monkeypatch.delenv("PLSSVM_K_CACHE_BYTES")
    monkeypatch.delenv("PLSSVM_SPARSE_PANEL_SWEEP")
    svm_d = _train(csr.toarray(), y, kernel, devices=1)
    _assert_matches(svm.alphas, svm.bias_, svm_d.alphas, svm_d.bias_)
