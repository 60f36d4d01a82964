"""``plssvm-generate-data``: synthetic dataset generator.

Equivalent of ``utility_scripts/generate_data.py`` (``make_blobs`` in numpy,
sklearn's ``make_classification``/``make_gaussian_quantiles``, written as
LIBSVM or ARFF; used by the reference's test CMake to create its 5000x2000
stress set, ``tests/CMakeLists.txt:33-59``).  Flag-for-flag coverage of the
reference script: ``--format``, ``--problem`` (incl. the ``*_merged``
variants), ``--samples``/``--test_samples`` (paired train/test files),
``--features``, ``--plot`` (accepted, ignored — no display here).  The
reference always minmax-scales to [-1, 1]; here that is the opt-in
``--minmax_scale`` flag so raw cluster geometry stays available.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _blobs(samples: int, features: int, std: float, seed: int):
    """Two Gaussian clusters, the shape of sklearn's two-center
    ``make_blobs``: centers uniform in [-10, 10]^features, ``std`` per
    coordinate, samples split evenly and shuffled.  numpy only, so data of
    any size is made where sklearn is not installed."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(2, features))
    y = rng.permutation(np.arange(samples) % 2)
    X = centers[y] + rng.normal(scale=std, size=(samples, features))
    return X, y


def generate(problem: str, samples: int, features: int, seed: int = 42):
    """Labeled samples for one of the reference's five problem types
    (``utility_scripts/generate_data.py`` problem dispatch)."""
    if problem == "blobs":
        X, y = _blobs(samples, features, 1.0, seed)
    elif problem == "blobs_merged":
        # overlapping clusters (cluster_std=4.0 upstream)
        X, y = _blobs(samples, features, 4.0, seed)
    elif problem in ("planes", "planes_merged", "ball"):
        X, y = _sklearn_problem(problem, samples, features, seed)
    else:
        raise ValueError(f"unknown problem type '{problem}'")
    labels = np.where(y > 0, 1.0, -1.0)
    return X, labels


def _sklearn_problem(problem: str, samples: int, features: int, seed: int):
    from sklearn import datasets

    if problem == "planes":
        X, y = datasets.make_classification(
            n_samples=samples, n_features=features,
            n_informative=2, n_redundant=0, n_clusters_per_class=1,
            n_classes=2, random_state=seed,
        )
    elif problem == "planes_merged":
        X, y = datasets.make_classification(
            n_samples=samples, n_features=features,
            n_informative=features, n_redundant=0,
            n_classes=2, random_state=seed,
        )
    elif problem == "ball":
        X, y = datasets.make_gaussian_quantiles(
            n_samples=samples, n_features=features, n_classes=2, random_state=seed
        )
    return X, y


def minmax_scale(X: np.ndarray, lo: float = -1.0, hi: float = 1.0) -> np.ndarray:
    """Per-feature min-max scaling to [lo, hi] (the reference applies
    sklearn's ``minmax_scale(feature_range=[-1, 1])`` unconditionally).
    Constant features map to ``lo``."""
    mn = X.min(axis=0)
    span = X.max(axis=0) - mn
    span = np.where(span == 0.0, 1.0, span)
    return lo + (hi - lo) * (X - mn) / span


def _write(path: str, fmt: str, X, labels) -> None:
    if fmt == "arff":
        from ..io.arff import write_arff_file

        write_arff_file(path, X, labels)
    else:
        from ..io.libsvm import write_libsvm_file

        write_libsvm_file(path, X, labels, sparse=False)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="plssvm-generate-data", description="generate a synthetic data set"
    )
    parser.add_argument(
        "--output",
        help="output file; default '<samples>x<features>.<format>' "
             "(extension implies the format when --format is omitted)")
    parser.add_argument("--format", choices=["libsvm", "arff"],
                        help="the file format; either arff or libsvm")
    parser.add_argument("--samples", type=int, required=True,
                        help="the number of training samples to generate")
    parser.add_argument("--test_samples", type=int, default=0,
                        help="the number of test samples to generate "
                             "(written to '<base>_test.<format>'); default: 0")
    parser.add_argument("--features", type=int, required=True)
    parser.add_argument(
        "--problem", default="blobs",
        choices=["blobs", "blobs_merged", "planes", "planes_merged", "ball"],
        help="generator to use (planes*/ball need sklearn)",
    )
    parser.add_argument("--minmax_scale", action="store_true",
                        help="scale features to [-1, 1] per feature "
                             "(the reference script always does)")
    parser.add_argument("--plot", action="store_true",
                        help="accepted for reference-script compatibility; "
                             "ignored (no display attached)")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    if args.samples <= 0 or args.test_samples < 0 or args.features <= 0:
        parser.error("Number of samples and/or features cannot be 0 or negative!")

    fmt = args.format
    base = args.output
    if base is None:
        if fmt is None:
            parser.error("--format is required when --output is omitted")
        base = f"{args.samples}x{args.features}"
    if fmt is None:
        fmt = "arff" if base.endswith(".arff") else "libsvm"
    # reference behavior: strip a duplicated extension from --output
    if base.endswith("." + fmt):
        base = base[: -(len(fmt) + 1)]
    train_path = f"{base}.{fmt}"
    test_path = f"{base}_test.{fmt}"

    total = args.samples + args.test_samples
    try:
        X, labels = generate(args.problem, total, args.features, args.seed)
    except ValueError as exc:
        # e.g. planes/planes_merged need enough features for sklearn's
        # informative-feature constraints — a CLI error, not a traceback
        parser.error(str(exc))
    if args.minmax_scale:
        # scaled over train+test together, like the reference
        X = minmax_scale(X)
    if args.plot:
        print("--plot is accepted for compatibility but ignored (no display).")

    _write(train_path, fmt, X[: args.samples], labels[: args.samples])
    print(
        f"wrote {args.samples} x {args.features} '{args.problem}' set to {train_path}"
    )
    if args.test_samples > 0:
        _write(test_path, fmt, X[args.samples:], labels[args.samples:])
        print(
            f"wrote {args.test_samples} x {args.features} '{args.problem}' "
            f"test set to {test_path}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
