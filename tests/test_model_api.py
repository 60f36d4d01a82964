"""CSVM API tests: ctor validation, learn/predict/accuracy contracts,
write_model, and golden-file parity against the reference's models.

Ports the reference's ``csvm_test.cpp`` (mock-based base-class contracts) and
the shared generic backend suite ``tests/backends/generic_tests.hpp``
(``write_model_test``, ``predict_test``, ``accuracy_test``) — with real golden
files instead of a mock, since the XLA path runs everywhere.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp

import plssvm_sparse_fp22 as pt
from plssvm_sparse_fp22.exceptions import PLSSVMError
from plssvm_sparse_fp22.io.libsvm import ParsedData, parse_libsvm_file
from plssvm_sparse_fp22.io.model import parse_model_file
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType

from utils import make_blobs


def _params_from_arrays(X, y=None, alphas=None, **kw):
    X = np.asarray(X, np.float64)
    p = Parameter(dtype=np.float64, **kw)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = None if y is None else np.asarray(y, np.float64)
    if alphas is not None:
        p.alphas = np.asarray(alphas, np.float64)
    if p.gamma == 0.0:
        p.gamma = 1.0 / X.shape[1]
    return p


class TestConstructorValidation:
    """ctor contracts (``csvm.cpp:41-57``, ``csvm_test.cpp``)."""

    def test_no_data(self):
        with pytest.raises(PLSSVMError, match="No data points provided!"):
            pt.CSVM(Parameter())

    def test_empty_data(self):
        p = Parameter()
        p.data = ParsedData(csr=sp.csr_matrix((0, 4)), values=None)
        with pytest.raises(PLSSVMError, match="Data set is empty!"):
            pt.CSVM(p)

    def test_no_features(self):
        p = Parameter()
        p.data = ParsedData(csr=sp.csr_matrix((3, 0)), values=None)
        with pytest.raises(PLSSVMError, match="No features provided"):
            pt.CSVM(p)

    def test_alpha_size_mismatch(self):
        p = _params_from_arrays(np.ones((3, 2)), alphas=np.ones(2))
        with pytest.raises(PLSSVMError, match="Number of weights"):
            pt.CSVM(p)


class TestLearnContracts:
    def test_learn_without_labels(self):
        svm = pt.CSVM(_params_from_arrays(np.ones((3, 2))))
        with pytest.raises(PLSSVMError, match="No labels given for training!"):
            svm.learn()

    def test_label_count_mismatch(self):
        p = _params_from_arrays(np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0]))
        svm = pt.CSVM(p)
        svm.values = svm.values[:2]
        with pytest.raises(PLSSVMError, match="Number of labels"):
            svm.learn()

    def test_write_model_before_learn(self, tmp_path):
        p = _params_from_arrays(np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0]))
        svm = pt.CSVM(p)
        with pytest.raises(PLSSVMError, match="No alphas given!"):
            svm.write_model(str(tmp_path / "m.model"))

    def test_predict_before_learn(self):
        p = _params_from_arrays(np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0]))
        svm = pt.CSVM(p)
        with pytest.raises(PLSSVMError, match="No alphas provided for prediction!"):
            svm.predict(np.ones((1, 2)))

    def test_predict_feature_mismatch(self):
        p = _params_from_arrays(np.ones((3, 2)), y=np.array([1.0, -1.0, 1.0]),
                                alphas=np.zeros(3))
        svm = pt.CSVM(p)
        with pytest.raises(PLSSVMError, match="must match"):
            svm.predict(np.ones((1, 5)))


@pytest.mark.parametrize("kernel", [KernelType.linear, KernelType.polynomial, KernelType.rbf])
class TestLearnPredict:
    def test_blobs_accuracy(self, kernel):
        X, y = make_blobs(80, 6, seed=3)
        # imax defaults to num_features (= 6 here, csvm.cpp:256) which stops
        # CG long before convergence; raise the cap to test converged quality
        p = _params_from_arrays(X, y=y, kernel=kernel, coef0=1.0, max_iter=200)
        svm = pt.make_csvm(p)
        svm.print_info = False
        svm.learn()
        assert svm.accuracy() >= 0.95
        # single-point overloads (csvm.cpp:280-288,321-340)
        v = svm.predict(X[0])
        assert np.isscalar(v) or v.ndim == 0
        assert svm.predict_label(X[0]) in (1.0, -1.0)

    def test_model_roundtrip(self, kernel, tmp_path):
        """learn -> write_model -> parse -> predict == in-memory predict."""
        X, y = make_blobs(40, 5, seed=11)
        p = _params_from_arrays(X, y=y, kernel=kernel, coef0=0.5)
        svm = pt.make_csvm(p)
        svm.print_info = False
        svm.learn()
        path = str(tmp_path / "rt.model")
        svm.write_model(path)

        p2 = Parameter(dtype=np.float64)
        p2.parse_model_file(path)
        svm2 = pt.make_csvm(p2)
        svm2.print_info = False

        P, _ = make_blobs(10, 5, seed=12)
        out1 = svm.predict(P)
        out2 = svm2.predict(P)
        # SV values pass through {:e} (7 significant digits)
        np.testing.assert_allclose(out1, out2, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(svm.predict_label(P), svm2.predict_label(P))


class TestGoldenParity:
    """End-to-end parity with the reference's golden files
    (``generic_tests.hpp:229-277``)."""

    @pytest.mark.parametrize("kernel_name", ["linear", "polynomial", "rbf"])
    def test_predict_with_reference_model(self, reference_data_dir, kernel_name):
        """Load a reference-trained model, predict its test set, compare with
        the golden predict file — label-exact (``predict_test``,
        ``generic_tests.hpp:229-258``: the same golden predict file validates
        all three kernel models)."""
        p = Parameter(dtype=np.float64)
        p.parse_model_file(f"{reference_data_dir}/models/500x200.libsvm.{kernel_name}.model")
        p.parse_test_file(f"{reference_data_dir}/libsvm/500x200.libsvm.test")
        svm = pt.make_csvm(p)
        svm.print_info = False
        labels = svm.predict_label(p.test_data.dense)
        golden = np.loadtxt(f"{reference_data_dir}/predict/500x200.libsvm.predict")
        np.testing.assert_array_equal(labels, golden)

    @pytest.mark.parametrize("kernel_name", ["linear", "polynomial", "rbf"])
    def test_train_500x200(self, reference_data_dir, kernel_name):
        """Train on the reference's 500x200 set with the golden model's
        hyperparameters: training must classify the training set well.  (The
        reference's own suite never compares retrained models against the
        golden ones — those were produced with unrecorded cost/epsilon — it
        only golden-checks prediction, covered above.)"""
        golden = parse_model_file(
            f"{reference_data_dir}/models/500x200.libsvm.{kernel_name}.model"
        )
        # epsilon=1e-6: with the reference's x0 = 1 start, delta0 is huge and
        # the default 1e-3 tolerance accepts a one-iteration "solution"
        p = Parameter(dtype=np.float64, kernel=golden.kernel, max_iter=1000, epsilon=1e-6)
        if golden.gamma is not None:
            p.gamma = golden.gamma
        if golden.degree is not None:
            p.degree = golden.degree
        if golden.coef0 is not None:
            p.coef0 = golden.coef0
        p.parse_train_file(f"{reference_data_dir}/libsvm/500x200.libsvm")
        svm = pt.make_csvm(p)
        svm.print_info = False
        svm.learn()
        assert svm.accuracy() >= 0.97

    def test_train_5x4_matches_golden_model(self, reference_data_dir):
        golden = parse_model_file(f"{reference_data_dir}/models/5x4.libsvm.model")
        p = Parameter(dtype=np.float64)
        p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        svm = pt.make_csvm(p)
        svm.print_info = False
        svm.learn()
        assert -svm.bias_ == pytest.approx(golden.rho, abs=1e-6)
        # golden alphas are ordered pos-first; ours are in data order
        got = np.sort(svm.alphas)
        want = np.sort(np.asarray(golden.alphas))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_written_model_header_regex(self, reference_data_dir, tmp_path):
        """Header validation mirroring ``write_model_test``
        (``generic_tests.hpp:56-118``)."""
        p = Parameter(dtype=np.float64)
        p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        svm = pt.make_csvm(p)
        svm.print_info = False
        svm.learn()
        path = tmp_path / "out.model"
        svm.write_model(str(path))
        content = path.read_text()
        pattern = (
            r"^svm_type c_svc\n"
            r"kernel_type linear\n"
            r"nr_class 2\n"
            r"total_sv [0-9]+\n"
            r"rho [-+0-9.e]+\n"
            r"label 1 -1\n"
            r"nr_sv [0-9]+ [0-9]+\n"
            r"SV\n"
        )
        assert re.match(pattern, content), content[:200]

    def test_reference_can_read_our_model_format(self, reference_data_dir, tmp_path):
        """Our written model parses back through our strict reference-parity
        parser (which enforces the reference's validation rules)."""
        p = Parameter(dtype=np.float64, kernel=KernelType.rbf)
        p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        svm = pt.make_csvm(p)
        svm.print_info = False
        svm.learn()
        path = str(tmp_path / "rt.model")
        svm.write_model(path)
        m = parse_model_file(path)
        assert m.kernel == KernelType.rbf
        assert m.support_vectors.num_points == 5


class TestAccuracyOverloads:
    def test_accuracy_empty_points(self):
        X, y = make_blobs(10, 3)
        p = _params_from_arrays(X, y=y, alphas=np.zeros(10))
        svm = pt.CSVM(p)
        assert svm.accuracy(np.zeros((0, 3)), np.zeros(0)) == 0.0

    def test_accuracy_count_mismatch(self):
        X, y = make_blobs(10, 3)
        p = _params_from_arrays(X, y=y, alphas=np.zeros(10))
        svm = pt.CSVM(p)
        with pytest.raises(PLSSVMError, match="must match number of"):
            svm.accuracy(np.zeros((2, 3)), np.zeros(3))

    def test_accuracy_no_labels(self):
        p = _params_from_arrays(np.ones((3, 2)))
        svm = pt.CSVM(p)
        with pytest.raises(PLSSVMError, match="No labels given!"):
            svm.accuracy()
