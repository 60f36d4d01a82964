"""CLI end-to-end tests: train -> model file -> predict -> labels.

Port of the reference's CLI smoke tests (``tests/CMakeLists.txt:115-116``)
plus a full train/predict pipeline over the reference fixtures.
"""

import numpy as np
import pytest

from plssvm_sparse_fp22.cli.predict import main as predict_main
from plssvm_sparse_fp22.cli.train import main as train_main
from plssvm_sparse_fp22.io.model import parse_model_file
from plssvm_sparse_fp22.types import KernelType


def test_train_help(capsys):
    with pytest.raises(SystemExit) as e:
        train_main(["--help"])
    assert e.value.code == 0
    assert "kernel" in capsys.readouterr().out


def test_predict_help(capsys):
    with pytest.raises(SystemExit) as e:
        predict_main(["--help"])
    assert e.value.code == 0


def test_train_missing_input(capsys):
    with pytest.raises(SystemExit):
        train_main([])


def test_train_gamma_zero_rejected(reference_data_dir, capsys):
    rc = train_main(["-g", "0", f"{reference_data_dir}/libsvm/5x4.libsvm"])
    assert rc == 1
    assert "gamma = 0.0 is not allowed" in capsys.readouterr().err


def test_train_missing_file(capsys):
    rc = train_main(["/nonexistent/data.libsvm"])
    assert rc == 1
    assert "Couldn't find file" in capsys.readouterr().err


@pytest.mark.parametrize("kernel_flag", ["0", "linear", "2"])
def test_train_predict_pipeline(reference_data_dir, tmp_path, kernel_flag, capsys):
    train_file = f"{reference_data_dir}/libsvm/500x200.libsvm"
    model_file = str(tmp_path / "out.model")
    predict_file = str(tmp_path / "out.predict")

    rc = train_main(["-t", kernel_flag, "-e", "1e-6", "--max_iter", "1000", "-q",
                     train_file, model_file])
    assert rc == 0
    model = parse_model_file(model_file)
    expected_kernel = KernelType.from_string(kernel_flag)
    assert model.kernel == expected_kernel

    rc = predict_main(["-q", train_file, model_file, predict_file])
    assert rc == 0
    out = capsys.readouterr().out
    # train data has labels -> accuracy line printed (main_predict.cpp:92-105)
    assert "Accuracy = " in out and "(classification)" in out
    labels = np.loadtxt(predict_file)
    assert labels.shape == (500,)
    assert set(np.unique(labels)) <= {-1.0, 1.0}
    # converged training classifies the training set well
    acc = float(out.split("Accuracy = ")[1].split("%")[0])
    assert acc >= 97.0


def test_predict_golden_parity(reference_data_dir, tmp_path):
    """predict CLI with the reference's model reproduces its golden labels."""
    predict_file = str(tmp_path / "golden.predict")
    rc = predict_main([
        "-q",
        f"{reference_data_dir}/libsvm/500x200.libsvm.test",
        f"{reference_data_dir}/models/500x200.libsvm.linear.model",
        predict_file,
    ])
    assert rc == 0
    got = np.loadtxt(predict_file)
    golden = np.loadtxt(f"{reference_data_dir}/predict/500x200.libsvm.predict")
    np.testing.assert_array_equal(got, golden)


def test_train_arff(reference_data_dir, tmp_path):
    model_file = str(tmp_path / "arff.model")
    rc = train_main(["-q", f"{reference_data_dir}/arff/5x4.arff", model_file])
    assert rc == 0
    assert parse_model_file(model_file).support_vectors.num_points == 5
