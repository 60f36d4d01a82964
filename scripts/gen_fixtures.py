"""Generate the self-contained golden test fixtures in ``tests/data/``.

The reference ships golden LIBSVM/ARFF data + model + predict fixtures
(``/root/reference/tests/data``); the test suite cross-checks against those
when that tree is present.  These fixtures serve the same role without the
reference installed: data written by our generator, golden alphas/bias from
the pure-numpy oracle (``utils/oracle.py`` — deterministic, no JAX), model
files from the byte-compatible writer, predictions from the oracle kernel
expansion.

Deterministic: fixed seeds, pure numpy.  Re-run only when the fixture
format deliberately changes:  python scripts/gen_fixtures.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from plssvm_sparse_fp22.io.libsvm import write_libsvm_file
from plssvm_sparse_fp22.io.arff import write_arff_file
from plssvm_sparse_fp22.io.model import write_model_file
from plssvm_sparse_fp22.types import KernelType
from plssvm_sparse_fp22.utils import oracle

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data")

HYPER = {"degree": 3, "gamma": 0.125, "coef0": 1.0}
COST, EPS = 2.0, 1e-8


def make_data(n=120, f=16, seed=20260820, sparsity=0.0):
    rng = np.random.default_rng(seed)
    half = n // 2
    X = np.concatenate([
        rng.normal(loc=+1.0, scale=1.0, size=(half, f)),
        rng.normal(loc=-1.0, scale=1.0, size=(n - half, f)),
    ])
    if sparsity > 0.0:
        X[rng.random(X.shape) < sparsity] = 0.0
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    # round to 6 significant digits so the on-disk text IS the dataset
    X = np.asarray([[float(f"{v:.6g}") for v in row] for row in X[perm]])
    return X, y[perm]


def main():
    os.makedirs(OUT, exist_ok=True)
    X, y = make_data()
    n, f = X.shape

    write_libsvm_file(os.path.join(OUT, "120x16.libsvm"), X, y)
    write_arff_file(os.path.join(OUT, "120x16.arff"), X, y)
    Xs, ys = make_data(seed=20260821, sparsity=0.6)
    write_libsvm_file(os.path.join(OUT, "120x16.sparse.libsvm"), Xs, ys,
                      sparse=True)

    Xt, yt = make_data(n=40, seed=7)
    write_libsvm_file(os.path.join(OUT, "40x16.test.libsvm"), Xt, yt)

    for kernel in (KernelType.linear, KernelType.polynomial, KernelType.rbf):
        alphas, bias, info = oracle.solve_lssvm(
            X, y, kernel=kernel, cost=COST, epsilon=EPS, max_iter=200, **HYPER)
        model_path = os.path.join(OUT, f"120x16.{kernel.name}.model")
        write_model_file(
            model_path, kernel=kernel, rho=-bias, data=X, labels=y,
            alphas=alphas, **HYPER)
        scores = oracle.kernel_matrix(kernel, Xt, X, **HYPER) @ alphas + bias
        labels = np.where(scores > 0.0, 1, -1)
        with open(os.path.join(OUT, f"40x16.{kernel.name}.predict"), "w") as fh:
            fh.write("\n".join(str(v) for v in labels) + "\n")
        print(f"{kernel.name}: iters={info['iterations']} "
              f"train_acc={(np.sign(oracle.kernel_matrix(kernel, X, X, **HYPER) @ alphas + bias) == y).mean():.3f}")

    print(f"fixtures written to {OUT}")


if __name__ == "__main__":
    main()
