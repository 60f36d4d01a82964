"""CG-state checkpoint/resume tests."""

import numpy as np
import pytest
import scipy.sparse as sp

import plssvm_sparse_fp22 as pt
from plssvm_sparse_fp22.exceptions import PLSSVMError
from plssvm_sparse_fp22.io.libsvm import ParsedData
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType

from utils import make_blobs


def _params(X, y, path=None, interval=50, **kw):
    p = Parameter(dtype=np.float64, checkpoint_path=path,
                  checkpoint_interval=interval, **kw)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=np.asarray(X))
    p.values = y
    if p.gamma == 0.0:
        p.gamma = 1.0 / X.shape[1]
    return p


def _slow_problem():
    """A system needing many CG iterations (spread Gram spectrum)."""
    rng = np.random.default_rng(7)
    n, f = 120, 200
    X = rng.normal(size=(n, f)) * np.geomspace(1, 100, f)
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return X, y


def test_checkpointed_matches_plain(tmp_path):
    X, y = _slow_problem()
    kw = dict(kernel=KernelType.linear, epsilon=1e-8, max_iter=300)

    plain = pt.CSVM(_params(X, y, **kw))
    plain.print_info = False
    plain.learn()

    path = str(tmp_path / "cg.ckpt.npz")
    ck = pt.CSVM(_params(X, y, path=path, interval=40, **kw))
    ck.print_info = False
    ck.learn()

    assert plain.last_cg_info["iterations"] > 40  # several chunks ran
    # chunked while_loop boundaries can shift convergence by an iteration
    assert abs(ck.last_cg_info["iterations"] - plain.last_cg_info["iterations"]) <= 2
    np.testing.assert_allclose(ck.alphas, plain.alphas, rtol=1e-4, atol=1e-6)
    assert ck.bias_ == pytest.approx(plain.bias_, rel=1e-4, abs=1e-6)


def test_resume_from_partial(tmp_path):
    X, y = _slow_problem()
    path = str(tmp_path / "cg.ckpt.npz")
    kw = dict(kernel=KernelType.linear, epsilon=1e-8)

    # run only 30 iterations, leaving a checkpoint behind
    partial = pt.CSVM(_params(X, y, path=path, interval=10, max_iter=30, **kw))
    partial.print_info = False
    partial.learn()
    assert partial.last_cg_info["iterations"] == 30

    # resume to full convergence
    resumed = pt.CSVM(_params(X, y, path=path, interval=50, max_iter=300, **kw))
    resumed.print_info = False
    resumed.learn()
    assert resumed.last_cg_info["iterations"] > 30

    plain = pt.CSVM(_params(X, y, max_iter=300, **kw))
    plain.print_info = False
    plain.learn()
    np.testing.assert_allclose(resumed.alphas, plain.alphas, rtol=1e-3, atol=1e-5)


def test_mismatched_checkpoint_rejected(tmp_path):
    X, y = _slow_problem()
    path = str(tmp_path / "cg.ckpt.npz")
    first = pt.CSVM(_params(X, y, path=path, interval=10, max_iter=20,
                            kernel=KernelType.linear, epsilon=1e-8))
    first.print_info = False
    first.learn()

    X2, y2 = make_blobs(50, 8, seed=1)
    other = pt.CSVM(_params(X2, y2, path=path, kernel=KernelType.linear))
    other.print_info = False
    with pytest.raises(PLSSVMError, match="does not match"):
        other.learn()
