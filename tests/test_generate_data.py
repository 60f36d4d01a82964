"""plssvm-generate-data CLI: flag-for-flag coverage of the reference's
``utility_scripts/generate_data.py`` (problems incl. merged variants,
paired train/test output, minmax scaling)."""

import numpy as np
import pytest

from plssvm_sparse_fp22.cli.generate_data import generate, main, minmax_scale
from plssvm_sparse_fp22.io.arff import parse_arff_file
from plssvm_sparse_fp22.io.libsvm import parse_libsvm_file


@pytest.mark.parametrize(
    "problem", ["blobs", "blobs_merged", "planes", "planes_merged", "ball"])
def test_problems_generate(problem):
    X, y = generate(problem, 60, 4, seed=1)
    assert X.shape == (60, 4)
    assert set(np.unique(y)) <= {-1.0, 1.0}


def test_paired_train_test_files(tmp_path):
    base = tmp_path / "pair"
    rc = main(["--output", str(base), "--format", "libsvm", "--samples", "50",
               "--test_samples", "20", "--features", "6"])
    assert rc == 0
    train = parse_libsvm_file(str(base) + ".libsvm")
    test = parse_libsvm_file(str(base) + "_test.libsvm")
    assert train.num_points == 50 and test.num_points == 20
    assert train.num_features == 6


def test_default_output_name_and_duplicate_extension(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["--format", "libsvm", "--samples", "10", "--features", "3"]) == 0
    assert (tmp_path / "10x3.libsvm").exists()
    # reference behavior: '--output x.libsvm --format libsvm' -> x.libsvm
    assert main(["--output", "dup.libsvm", "--format", "libsvm",
                 "--samples", "5", "--features", "2"]) == 0
    assert (tmp_path / "dup.libsvm").exists()
    assert not (tmp_path / "dup.libsvm.libsvm").exists()


def test_arff_output(tmp_path):
    out = tmp_path / "g.arff"
    assert main(["--output", str(out), "--samples", "12", "--features", "3",
                 "--problem", "ball"]) == 0
    parsed = parse_arff_file(str(out))
    assert parsed.num_points == 12 and parsed.num_features == 3


def test_minmax_scale_flag(tmp_path):
    out = tmp_path / "s.libsvm"
    assert main(["--output", str(out), "--samples", "40", "--features", "4",
                 "--minmax_scale"]) == 0
    parsed = parse_libsvm_file(str(out))
    X = parsed.dense
    assert X.min() >= -1.0 - 1e-12 and X.max() <= 1.0 + 1e-12


def test_minmax_scale_constant_feature():
    X = np.array([[1.0, 5.0], [1.0, 7.0], [1.0, 9.0]])
    S = minmax_scale(X)
    np.testing.assert_allclose(S[:, 0], -1.0)
    np.testing.assert_allclose(S[:, 1], [-1.0, 0.0, 1.0])


def test_invalid_counts_rejected(tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["--output", str(tmp_path / "x.libsvm"), "--samples", "0",
              "--features", "3"])
    err = capsys.readouterr().err
    assert "cannot be 0 or negative" in err


def test_plot_accepted_and_ignored(tmp_path, capsys):
    out = tmp_path / "p.libsvm"
    assert main(["--output", str(out), "--samples", "8", "--features", "2",
                 "--plot"]) == 0
    assert "ignored" in capsys.readouterr().out


@pytest.mark.parametrize("problem,std", [("blobs", 1.0), ("blobs_merged", 4.0)])
def test_blobs_numpy_generator(problem, std):
    """The blob problems need only numpy: two balanced clusters, same data
    for the same seed, spread set by the problem's cluster std."""
    X, y = generate(problem, 400, 8, seed=3)
    X2, y2 = generate(problem, 400, 8, seed=3)
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(y, y2)
    assert abs(int(np.sum(y > 0)) - 200) == 0
    within = X[y > 0] - X[y > 0].mean(axis=0)
    assert abs(float(within.std()) - std) < 0.15 * std
