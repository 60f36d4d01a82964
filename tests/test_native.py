"""Native C++ parser tests: exact parity with the Python parser.

The native layer is optional; all tests skip when the toolchain can't build
the shared library.
"""

import numpy as np
import pytest

from plssvm_sparse_fp22.exceptions import (
    FileNotFoundError_,
    InvalidFileFormatError,
)
from plssvm_sparse_fp22.io.libsvm import parse_libsvm_content, write_libsvm_file
from plssvm_sparse_fp22.io.native import get_native_lib, parse_libsvm_native


pytestmark = pytest.mark.skipif(
    get_native_lib() is None, reason="native library not available"
)


def _python_parse(path):
    from plssvm_sparse_fp22.io.file_reader import read_lines

    return parse_libsvm_content(read_lines(path, "#"))


@pytest.mark.parametrize(
    "fixture",
    ["5x4.libsvm", "5x4.sparse.libsvm", "5x4.libsvm.no_label", "500x200.libsvm"],
)
def test_parity_with_python_parser(reference_data_dir, fixture):
    path = f"{reference_data_dir}/libsvm/{fixture}"
    native = parse_libsvm_native(path)
    py = _python_parse(path)
    np.testing.assert_array_equal(native[0].toarray(), py[0].toarray())
    if not py[2]:
        np.testing.assert_array_equal(native[1], py[1])
    assert native[2] == py[2]


def test_parity_random_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    X = np.where(rng.random((50, 30)) < 0.3, rng.normal(size=(50, 30)), 0.0)
    X[0, 0] = 1e-300  # subnormal-ish magnitudes survive round-trip
    y = np.where(rng.normal(size=50) > 0, 1.0, -1.0)
    path = str(tmp_path / "rt.libsvm")
    write_libsvm_file(path, X, y)
    native = parse_libsvm_native(path)
    py = _python_parse(path)
    # bitwise value parity: both use correctly-rounded decimal conversion
    np.testing.assert_array_equal(native[0].toarray(), py[0].toarray())
    np.testing.assert_array_equal(native[1], py[1])


def test_missing_file():
    with pytest.raises(FileNotFoundError_, match="Couldn't find file"):
        parse_libsvm_native("/nonexistent/x.libsvm")


def test_bad_value(tmp_path):
    p = tmp_path / "bad.libsvm"
    p.write_text("1 0:abc\n")
    with pytest.raises(InvalidFileFormatError, match="Can't convert"):
        parse_libsvm_native(str(p))


def test_empty_file(tmp_path):
    p = tmp_path / "empty.libsvm"
    p.write_text("")
    with pytest.raises(InvalidFileFormatError, match="no data points"):
        parse_libsvm_native(str(p))


def test_inline_comment_tolerated(tmp_path):
    p = tmp_path / "c.libsvm"
    p.write_text("-1  2:0.5   # trailing comment\n1 0:1.0\n")
    native = parse_libsvm_native(str(p))
    assert native[0].shape == (2, 3)
    assert native[0][0, 2] == 0.5


class TestNativeModelWriter:
    """Byte parity of the native writer with the Python writer (the oracle)."""

    @staticmethod
    def _write_both(tmp_path, monkeypatch, data, labels, alphas, kernel=None, **kw):
        from plssvm_sparse_fp22.io.model import write_model_file
        from plssvm_sparse_fp22.types import KernelType

        kernel = kernel or KernelType.rbf
        native_path = str(tmp_path / "native.model")
        py_path = str(tmp_path / "python.model")
        write_model_file(native_path, kernel=kernel, rho=0.5, data=data,
                         labels=labels, alphas=alphas, **kw)
        # force the pure-Python path for the oracle file
        monkeypatch.setenv("PLSSVM_NO_NATIVE_PARSER", "1")
        write_model_file(py_path, kernel=kernel, rho=0.5, data=data,
                         labels=labels, alphas=alphas, **kw)
        monkeypatch.delenv("PLSSVM_NO_NATIVE_PARSER")
        return open(native_path, "rb").read(), open(py_path, "rb").read()

    def test_dense_byte_parity(self, tmp_path, monkeypatch):
        rng = np.random.default_rng(7)
        X = np.where(rng.random((40, 12)) < 0.5, rng.normal(size=(40, 12)), 0.0)
        y = np.where(rng.normal(size=40) > 0, 1.0, -1.0)
        alphas = rng.normal(size=40) * 10.0 ** rng.integers(-8, 8, size=40)
        a, b = self._write_both(tmp_path, monkeypatch, X, y, alphas, gamma=0.25)
        assert a == b

    def test_sparse_byte_parity(self, tmp_path, monkeypatch):
        import scipy.sparse as sp

        rng = np.random.default_rng(11)
        X = sp.random(60, 25, density=0.2, random_state=3, format="csr")
        y = np.where(rng.normal(size=60) > 0, 1.0, -1.0)
        alphas = rng.normal(size=60)
        a, b = self._write_both(tmp_path, monkeypatch, X, y, alphas)
        assert a == b

    def test_alpha_formatting_corpus(self, tmp_path, monkeypatch):
        """fmt_shortest parity across the double-format edge cases: integral
        values, fixed/scientific thresholds (1e-4, 1e16), subnormals."""
        corpus = np.array([
            1.0, -1.0, 0.0, -0.0, 0.5, -2.5, 0.1, 1e-4, 9.9999e-5, 1e-5,
            123456.0, 1e15, 1e16, -1e16, 9.999999999999998e15, 1e-300, 5e-324,
            3.141592653589793, 1.2300000000000001e-05, 2.0/3.0, 1e100, -1e-100,
        ])
        rng = np.random.default_rng(13)
        rand = rng.normal(size=500) * 10.0 ** rng.integers(-320, 300, size=500)
        alphas = np.concatenate([corpus, rand])
        n = len(alphas)
        X = np.ones((n, 1))
        y = np.concatenate([np.ones(n // 2), -np.ones(n - n // 2)])
        a, b = self._write_both(tmp_path, monkeypatch, X, y, alphas)
        assert a == b

    def test_roundtrip_through_parser(self, tmp_path):
        from plssvm_sparse_fp22.io.model import parse_model_file, write_model_file
        from plssvm_sparse_fp22.types import KernelType

        rng = np.random.default_rng(17)
        X = rng.normal(size=(30, 8))
        y = np.where(rng.normal(size=30) > 0, 1.0, -1.0)
        alphas = rng.normal(size=30)
        path = str(tmp_path / "rt.model")
        write_model_file(path, kernel=KernelType.polynomial, rho=-1.25, data=X,
                         labels=y, alphas=alphas, degree=4, gamma=0.5, coef0=1.5)
        m = parse_model_file(path)
        assert m.kernel == KernelType.polynomial
        assert m.rho == -1.25
        assert m.degree == 4 and m.gamma == 0.5 and m.coef0 == 1.5
        order = np.concatenate([np.flatnonzero(y > 0), np.flatnonzero(y < 0)])
        # feature values go through "%e" (7 significant digits, csvm.cpp:144)
        np.testing.assert_allclose(m.support_vectors.csr.toarray(), X[order], rtol=1e-6)
        np.testing.assert_array_equal(m.alphas, alphas[order])


class TestNativeArffParser:
    """Native ARFF parser parity with the Python oracle (io/arff.py)."""

    @staticmethod
    def _python_parse(path):
        from plssvm_sparse_fp22.io import arff as arff_mod

        # bypass the native fast path inside parse_arff_file
        import plssvm_sparse_fp22.io.native as native_mod
        real = native_mod.parse_arff_native
        native_mod.parse_arff_native = lambda *a, **k: None
        try:
            return arff_mod.parse_arff_file(path)
        finally:
            native_mod.parse_arff_native = real

    @pytest.mark.parametrize("fixture", ["5x4.arff", "5x4.arff.no_label"])
    def test_parity_with_python_parser(self, reference_data_dir, fixture):
        from plssvm_sparse_fp22.io.native import parse_arff_native

        path = f"{reference_data_dir}/arff/{fixture}"
        native_csr, native_labels = parse_arff_native(path)
        py = self._python_parse(path)
        np.testing.assert_array_equal(native_csr.toarray(), py.dense)
        if py.values is None:
            assert native_labels is None
        else:
            np.testing.assert_array_equal(native_labels, py.values)

    def test_sparse_rows_parity(self, tmp_path):
        """Sparse {idx value, ...} rows, mixed with dense rows."""
        from plssvm_sparse_fp22.io.native import parse_arff_native

        p = tmp_path / "mixed.arff"
        p.write_text(
            "% comment\n"
            "@RELATION mixed\n"
            "@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b numeric\n@ATTRIBUTE c NUMERIC\n"
            "@ATTRIBUTE class NUMERIC\n"
            "@DATA\n"
            "{0 1.5, 3 1}\n"
            "-0.25,3.5,0.0,-1\n"
            "{1 -2.25, 2 4.5, 3 -1}\n"
            "{3 -2}\n"
        )
        csr, labels = parse_arff_native(str(p))
        py = self._python_parse(str(p))
        np.testing.assert_array_equal(csr.toarray(), py.dense)
        np.testing.assert_array_equal(labels, py.values)
        np.testing.assert_array_equal(labels, [1.0, -1.0, -1.0, -1.0])

    @pytest.mark.parametrize(
        "content, message",
        [
            ("@ATTRIBUTE a STRING\n@DATA\n1\n", "Can only use NUMERIC features"),
            ("@ATTRIBUTE c class NUMERIC\n@ATTRIBUTE a NUMERIC\n@DATA\n1,1\n",
             "Only the last ATTRIBUTE may be CLASS!"),
            ("@DATA\n1.0\n", "no ATTRIBUTES are defined!"),
            ("@ATTRIBUTE a NUMERIC\n", "no data points are given or @DATA is missing!"),
            ("@ATTRIBUTE a NUMERIC\n@DATA\n@RELATION x\n", "Read @ inside data section!"),
            ("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n@DATA\n{0 1.0\n",
             "Missing closing '}' for sparse data point 0"),
            ("@ATTRIBUTE a NUMERIC\n@DATA\n{zzz}\n", "Invalid sparse entry 'zzz' for data point 0!"),
            ("@ATTRIBUTE a NUMERIC\n@DATA\n{5 1.0}\n", "Too many features given!"),
            ("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE c class NUMERIC\n@DATA\n{0 1.0}\n",
             "Missing label for data point 0!"),
            ("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n@DATA\n1.0\n",
             "Invalid number of features/labels! Found 0 but should be 1!"),
            ("@ATTRIBUTE a NUMERIC\n@DATA\n1.0,2.0,3.0\n",
             "Too many features! Superfluous '2.0,3.0' for data point 0!"),
            ("@ATTRIBUTE a NUMERIC\n@DATA\nxyz\n",
             "Can't convert 'xyz' to a value of type real_type!"),
            ("@ATTRIBUTE a NUMERIC\n@DATA\n{0 abc}\n",
             "Can't convert 'abc' to a value of type real_type!"),
            ("@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n@DATA\n{1.5 2.0}\n",
             "Can't convert '1.5' to a value of type unsigned long!"),
        ],
    )
    def test_error_message_parity(self, tmp_path, content, message):
        """Both parsers reject with the same message."""
        import re

        from plssvm_sparse_fp22.io.native import parse_arff_native

        p = tmp_path / "bad.arff"
        p.write_text(content)
        with pytest.raises(InvalidFileFormatError, match=re.escape(message)):
            parse_arff_native(str(p))
        with pytest.raises(InvalidFileFormatError, match=re.escape(message)):
            self._python_parse(str(p))

    def test_sparse_duplicate_last_wins(self, tmp_path):
        """Duplicate sparse indices: the Python oracle assigns into a dense
        row, so the last value wins — native must match."""
        p = tmp_path / "dup.arff"
        p.write_text(
            "@ATTRIBUTE a NUMERIC\n@ATTRIBUTE b NUMERIC\n"
            "@ATTRIBUTE c class NUMERIC\n@DATA\n{0 1.0, 0 3.5, 2 1}\n"
        )
        from plssvm_sparse_fp22.io.native import parse_arff_native

        csr, labels = parse_arff_native(str(p))
        py = self._python_parse(str(p))
        np.testing.assert_array_equal(csr.toarray(), [[3.5, 0.0]])
        np.testing.assert_array_equal(csr.toarray(), py.dense)
        np.testing.assert_array_equal(labels, py.values)

    def test_random_roundtrip_parity(self, tmp_path):
        from plssvm_sparse_fp22.io.arff import write_arff_file
        from plssvm_sparse_fp22.io.native import parse_arff_native

        rng = np.random.default_rng(5)
        X = np.where(rng.random((80, 17)) < 0.4, rng.normal(size=(80, 17)), 0.0)
        y = np.where(rng.normal(size=80) > 0, 1.0, -1.0)
        path = str(tmp_path / "rt.arff")
        write_arff_file(path, X, y)
        csr, labels = parse_arff_native(path)
        py = self._python_parse(path)
        np.testing.assert_array_equal(csr.toarray(), py.dense)
        np.testing.assert_array_equal(labels, py.values)
