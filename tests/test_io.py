"""Parser/writer tests.

Port of the reference's parser test matrix (``tests/parameter_test.cpp``):
dense/sparse/no-label LIBSVM and ARFF fixtures, model files, and ill-formed
inputs, checked against the reference's own data files where available.
"""

import numpy as np
import pytest

from plssvm_sparse_fp22.exceptions import (
    FileNotFoundError_,
    InvalidFileFormatError,
)
from plssvm_sparse_fp22.io.arff import parse_arff_file
from plssvm_sparse_fp22.io.fmtlib import fmt_scientific, fmt_shortest
from plssvm_sparse_fp22.io.libsvm import parse_libsvm_file, write_libsvm_file
from plssvm_sparse_fp22.io.model import parse_model_file, write_model_file
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType

# the 5x4 fixture values (tests/data/libsvm/5x4.libsvm)
EXPECTED_5X4 = np.array(
    [
        [-1.117827500607882, -2.9087188881250993, 0.66638344270039144, 1.0978832703949288],
        [-0.5282118298909262, -0.335880984968183973, 0.51687296029754564, 0.54604461446026],
        [0.57650218263054642, 1.01405596624706053, 0.13009428079760464, 0.7261913886869387],
        [-0.20981208921241892, 0.60276937379453293, -0.13086851759108944, 0.10805254527169827],
        [1.88494043717792, 1.00518564317278263, 0.298499933047586044, 1.6464627048813514],
    ]
)
EXPECTED_5X4_LABELS = np.array([1.0, 1.0, -1.0, -1.0, -1.0])

# the sparse fixture densified (tests/data/libsvm/5x4.sparse.libsvm)
EXPECTED_5X4_SPARSE = np.array(
    [
        [0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.51687296029754564, 0.0],
        [0.0, 1.01405596624706053, 0.0, 0.0],
        [0.0, 0.60276937379453293, 0.0, -0.13086851759108944],
        [0.0, 0.0, 0.298499933047586044, 0.0],
    ]
)


class TestLibsvm:
    def test_dense(self, reference_data_dir):
        parsed = parse_libsvm_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        np.testing.assert_allclose(parsed.dense, EXPECTED_5X4)
        np.testing.assert_array_equal(parsed.values, EXPECTED_5X4_LABELS)
        assert parsed.num_points == 5 and parsed.num_features == 4

    def test_sparse_with_comments(self, reference_data_dir):
        parsed = parse_libsvm_file(f"{reference_data_dir}/libsvm/5x4.sparse.libsvm")
        np.testing.assert_allclose(parsed.dense, EXPECTED_5X4_SPARSE)
        np.testing.assert_array_equal(parsed.values, EXPECTED_5X4_LABELS)
        # CSR retained natively (capability extension)
        assert parsed.csr.nnz == 5
        assert parsed.density == pytest.approx(5 / 20)

    def test_no_label(self, reference_data_dir):
        parsed = parse_libsvm_file(f"{reference_data_dir}/libsvm/5x4.libsvm.no_label")
        assert parsed.values is None
        assert parsed.num_points == 5

    def test_empty_file(self, reference_data_dir):
        with pytest.raises(InvalidFileFormatError, match="no data points are given"):
            parse_libsvm_file(f"{reference_data_dir}/libsvm/0x0.libsvm")

    def test_missing_file(self):
        with pytest.raises(FileNotFoundError_, match="Couldn't find file"):
            parse_libsvm_file("/nonexistent/file.libsvm")

    def test_bad_value(self, tmp_path):
        f = tmp_path / "bad.libsvm"
        f.write_text("1 0:abc\n")
        with pytest.raises(InvalidFileFormatError):
            parse_libsvm_file(str(f))

    def test_bad_index(self, tmp_path):
        f = tmp_path / "bad.libsvm"
        f.write_text("1 x:1.0\n")
        with pytest.raises(InvalidFileFormatError):
            parse_libsvm_file(str(f))

    def test_mixed_label_presence_treated_unlabeled(self, tmp_path):
        # any unlabeled line flips the whole file to unlabeled
        # (values[0] = max sentinel, parameter.cpp:61-62)
        f = tmp_path / "mixed.libsvm"
        f.write_text("1 0:1.0\n0:2.0 1:3.0\n")
        parsed = parse_libsvm_file(str(f))
        assert parsed.values is None

    def test_duplicate_index_last_wins(self, tmp_path):
        f = tmp_path / "dup.libsvm"
        f.write_text("1 0:1.0 0:5.0 2:2.0\n-1 1:1.0\n")
        parsed = parse_libsvm_file(str(f))
        np.testing.assert_allclose(parsed.dense[0], [5.0, 0.0, 2.0])

    def test_roundtrip(self, tmp_path):
        X = np.array([[1.5, 0.0, -2.25], [0.0, 3.0, 0.125]])
        y = np.array([1.0, -1.0])
        path = tmp_path / "rt.libsvm"
        write_libsvm_file(path, X, y)
        parsed = parse_libsvm_file(str(path))
        np.testing.assert_allclose(parsed.dense, X)
        np.testing.assert_array_equal(parsed.values, y)


class TestArff:
    def test_dense_and_sparse_rows(self, reference_data_dir):
        parsed = parse_arff_file(f"{reference_data_dir}/arff/5x4.arff")
        # rows 0-2 dense, rows 3-4 sparse ({idx val, ...}); row 3 only sets
        # columns 1 and 2 (differs from the LIBSVM 5x4 fixture)
        expected = EXPECTED_5X4.copy()
        expected[3] = [0.0, 0.60276937379453293, -0.13086851759108944, 0.0]
        np.testing.assert_allclose(parsed.dense, expected)
        np.testing.assert_array_equal(parsed.values, EXPECTED_5X4_LABELS)

    def test_no_label(self, reference_data_dir):
        parsed = parse_arff_file(f"{reference_data_dir}/arff/5x4.arff.no_label")
        assert parsed.values is None
        assert parsed.num_features == 4

    def test_empty(self, reference_data_dir):
        with pytest.raises(InvalidFileFormatError):
            parse_arff_file(f"{reference_data_dir}/arff/0x4.arff")

    def test_non_numeric_attribute(self, tmp_path):
        f = tmp_path / "bad.arff"
        f.write_text("@ATTRIBUTE a STRING\n@DATA\n1\n")
        with pytest.raises(InvalidFileFormatError, match="NUMERIC"):
            parse_arff_file(str(f))

    def test_class_not_last(self, tmp_path):
        f = tmp_path / "bad.arff"
        f.write_text(
            "@ATTRIBUTE class NUMERIC\n@ATTRIBUTE a NUMERIC\n@DATA\n1,1\n"
        )
        with pytest.raises(InvalidFileFormatError, match="last ATTRIBUTE"):
            parse_arff_file(str(f))

    def test_at_inside_data(self, tmp_path):
        f = tmp_path / "bad.arff"
        f.write_text("@ATTRIBUTE a NUMERIC\n@DATA\n1\n@RELATION x\n")
        with pytest.raises(InvalidFileFormatError, match="@ inside data"):
            parse_arff_file(str(f))

    def test_sparse_missing_brace(self, tmp_path):
        f = tmp_path / "bad.arff"
        f.write_text("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n@DATA\n{0 1.0\n")
        with pytest.raises(InvalidFileFormatError, match="Missing closing"):
            parse_arff_file(str(f))

    def test_sparse_index_too_big(self, tmp_path):
        f = tmp_path / "bad.arff"
        f.write_text("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n@DATA\n{5 1.0}\n")
        with pytest.raises(InvalidFileFormatError, match="Too many features"):
            parse_arff_file(str(f))

    def test_dense_too_many_fields(self, tmp_path):
        f = tmp_path / "bad.arff"
        f.write_text("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n@DATA\n1,2,3\n")
        with pytest.raises(InvalidFileFormatError, match="Too many features"):
            parse_arff_file(str(f))


class TestModelFile:
    def test_parse_reference_model(self, reference_data_dir):
        m = parse_model_file(f"{reference_data_dir}/models/5x4.libsvm.model")
        assert m.kernel == KernelType.linear
        assert m.rho == 0.37330625882191915
        assert m.num_sv_pos == 2 and m.num_sv_neg == 3
        assert m.support_vectors.num_points == 5
        assert m.alphas[0] == pytest.approx(-0.17609610490769723)
        np.testing.assert_array_equal(m.labels, [1, 1, -1, -1, -1])

    def test_parse_polynomial_model(self, reference_data_dir):
        m = parse_model_file(f"{reference_data_dir}/models/5x4.libsvm.polynomial.model")
        assert m.kernel == KernelType.polynomial
        assert m.degree == 2 and m.gamma == 0.25 and m.coef0 == 1.0

    def test_parse_rbf_model(self, reference_data_dir):
        m = parse_model_file(f"{reference_data_dir}/models/500x200.libsvm.rbf.model")
        assert m.kernel == KernelType.rbf
        assert m.support_vectors.num_points == 214

    def test_bad_svm_type(self, tmp_path):
        f = tmp_path / "bad.model"
        f.write_text("svm_type nu_svc\nSV\n")
        with pytest.raises(InvalidFileFormatError, match="c_svc"):
            parse_model_file(str(f))

    def test_bad_nr_class(self, tmp_path):
        f = tmp_path / "bad.model"
        f.write_text("svm_type c_svc\nnr_class 3\nSV\n")
        with pytest.raises(InvalidFileFormatError, match="2 classes"):
            parse_model_file(str(f))

    def test_missing_rho(self, tmp_path):
        f = tmp_path / "bad.model"
        f.write_text(
            "svm_type c_svc\nkernel_type linear\nnr_class 2\ntotal_sv 1\n"
            "label 1 -1\nnr_sv 1 0\nSV\n1.0 0:1.0\n"
        )
        with pytest.raises(InvalidFileFormatError, match="rho"):
            parse_model_file(str(f))

    def test_bad_labels(self, tmp_path):
        f = tmp_path / "bad.model"
        f.write_text("svm_type c_svc\nlabel 2 -1\nSV\n")
        with pytest.raises(InvalidFileFormatError, match="labels 1 and -1"):
            parse_model_file(str(f))

    def test_nr_sv_mismatch(self, tmp_path):
        f = tmp_path / "bad.model"
        f.write_text(
            "svm_type c_svc\nkernel_type linear\nnr_class 2\ntotal_sv 3\n"
            "rho 0.5\nlabel 1 -1\nnr_sv 1 1\nSV\n"
        )
        with pytest.raises(InvalidFileFormatError, match="doesn't add up"):
            parse_model_file(str(f))

    def test_unrecognized_header(self, tmp_path):
        f = tmp_path / "bad.model"
        f.write_text("svm_type c_svc\nbogus_entry 1\nSV\n")
        with pytest.raises(InvalidFileFormatError, match="Unrecognized header entry"):
            parse_model_file(str(f))

    def test_write_parse_roundtrip(self, tmp_path):
        data = np.array([[1.0, 0.0, 2.5], [-1.0, 3.0, 0.0], [0.5, 0.5, 0.5]])
        labels = np.array([1.0, -1.0, 1.0])
        alphas = np.array([0.25, -0.125, 1.5])
        path = tmp_path / "m.model"
        write_model_file(
            path, kernel=KernelType.rbf, rho=0.75, data=data, labels=labels,
            alphas=alphas, gamma=0.5,
        )
        m = parse_model_file(str(path))
        assert m.kernel == KernelType.rbf
        assert m.rho == 0.75 and m.gamma == 0.5
        # positives first, then negatives
        np.testing.assert_allclose(m.alphas, [0.25, 1.5, -0.125])
        np.testing.assert_allclose(
            m.support_vectors.dense,
            np.array([[1.0, 0.0, 2.5], [0.5, 0.5, 0.5], [-1.0, 3.0, 0.0]]),
            atol=5e-7,  # SV values go through {:e} (6 significant digits)
        )

    def test_header_byte_format(self, tmp_path):
        """Header must byte-match the reference writer (csvm.cpp:93-155)."""
        path = tmp_path / "m.model"
        header = write_model_file(
            path, kernel=KernelType.linear, rho=0.37330625882191915,
            data=EXPECTED_5X4, labels=EXPECTED_5X4_LABELS,
            alphas=np.array([-0.17609610490769723, 0.8838187731213127,
                             -0.23146573996578407, -0.47971257671001616,
                             0.0034556484621847128]),
        )
        assert header == (
            "svm_type c_svc\n"
            "kernel_type linear\n"
            "nr_class 2\n"
            "total_sv 5\n"
            "rho 0.37330625882191915\n"
            "label 1 -1\n"
            "nr_sv 2 3\n"
            "SV\n"
        )
        content = path.read_text()
        # first SV line byte-matches the reference fixture's format
        first_sv = content.splitlines()[8]
        assert first_sv == (
            "-0.17609610490769723 0:-1.117828e+00 1:-2.908719e+00 "
            "2:6.663834e-01 3:1.097883e+00 "
        )


class TestFmt:
    def test_shortest(self):
        assert fmt_shortest(1.0) == "1"
        assert fmt_shortest(-1.0) == "-1"
        assert fmt_shortest(0.25) == "0.25"
        assert fmt_shortest(0.37330625882191915) == "0.37330625882191915"
        # shortest round-trip: parses back to the identical double
        s = fmt_shortest(0.0050251256281407036)
        assert float(s) == 0.0050251256281407036

    def test_scientific(self):
        assert fmt_scientific(-1.117827500607882) == "-1.117828e+00"
        assert fmt_scientific(0.66638344270039144) == "6.663834e-01"


class TestParameter:
    def test_gamma_auto(self, reference_data_dir):
        p = Parameter()
        p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        assert p.gamma == 0.25  # 1 / num_features (parameter.cpp:150-152)

    def test_gamma_explicit_kept(self, reference_data_dir):
        p = Parameter(gamma=2.0)
        p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        assert p.gamma == 2.0

    def test_train_requires_labels(self, reference_data_dir):
        p = Parameter()
        with pytest.raises(InvalidFileFormatError, match="Missing labels"):
            p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm.no_label")

    def test_model_filename_derivation(self, reference_data_dir):
        p = Parameter()
        p.parse_train_file(f"{reference_data_dir}/libsvm/5x4.libsvm")
        assert p.model_filename == "5x4.libsvm.model"

    def test_parse_model_file_sets_params(self, reference_data_dir):
        # predict CLI order: input (test) filename is set before the model is
        # parsed; predict_filename derives from the *test* file
        # (parameter_predict.cpp:28-34)
        p = Parameter()
        p.input_filename = "dir/5x4.libsvm.test"
        p.parse_model_file(f"{reference_data_dir}/models/5x4.libsvm.polynomial.model")
        assert p.kernel == KernelType.polynomial
        assert p.degree == 2 and p.gamma == 0.25 and p.coef0 == 1.0
        assert p.predict_filename == "5x4.libsvm.test.predict"
