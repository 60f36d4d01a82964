"""Precision/throughput frontier study.

Measures, per ``PLSSVM_MATMUL_PRECISION`` tier (``default``, ``high``,
``highest`` = exact f32; what XLA runs for each on the H100 is in
docs/PERF.md "Dot precision on the H100") and per kernel:

- end-to-end convergence through ``make_csvm``: CG iterations to the 1e-6
  tolerance, final training accuracy, bias delta vs the ``highest`` tier,
  max |alpha| delta vs ``highest``;
- warm implicit-CG throughput (two-point slope, eps=0 pinned iterations).

The precision env knob is read at import time, so every (tier, kernel)
cell runs in a fresh subprocess; this driver aggregates one JSON report.
Precedent for trading Gram-product precision for speed: the reference
builds its OpenCL kernels with ``-cl-fast-relaxed-math``
(``OpenCL/detail/utility.cpp:287``).

Usage: ``python scripts/precision_study.py [--n 4096] [--f 256]``.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
from plssvm_sparse_fp22.utils.compilation_cache import enable_compilation_cache
enable_compilation_cache()
import jax, jax.numpy as jnp
import scipy.sparse as sp
from plssvm_sparse_fp22.io.libsvm import ParsedData
from plssvm_sparse_fp22.models import make_csvm
from plssvm_sparse_fp22.models.base import _learn_jit
from plssvm_sparse_fp22.params import Parameter
from plssvm_sparse_fp22.types import KernelType
from plssvm_sparse_fp22.utils.timing import slope_rate

n, f = %(n)d, %(f)d
kernel = KernelType.from_string(%(kernel)r)
rng = np.random.default_rng(11)
half = n // 2
X = np.vstack([rng.normal(-0.4, 1.0, size=(half, f)),
               rng.normal(0.4, 1.0, size=(n - half, f))]).astype(np.float32)
y = np.concatenate([-np.ones(half), np.ones(n - half)])
perm = rng.permutation(n)
X, y = X[perm], y[perm]

def fresh():
    params = Parameter(kernel=kernel, gamma=1.0 / f, coef0=1.0, cost=1.0,
                       epsilon=1e-6, print_info=False, dtype=np.float32,
                       devices=1)
    params.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    params.values = y
    return make_csvm(params)

svm = fresh(); svm.learn()   # warm compile
svm = fresh()
t0 = time.perf_counter(); svm.learn(); learn_s = time.perf_counter() - t0
acc = svm.accuracy()

# throughput: slope-timed fixed-iteration CG on the same system
dept = n - 1
block = 256
D = ((dept + block - 1) // block) * block
X_pad = np.zeros((D, f), np.float32); X_pad[:dept] = X[:dept]
mask = np.zeros(D, np.float32); mask[:dept] = 1.0
mode = "implicit" if kernel != KernelType.linear else "linear"
kw = dict(kernel=kernel, degree=3, mode=mode)
Xd, xl, md = jnp.asarray(X_pad), jnp.asarray(X[-1].astype(np.float32)), jnp.asarray(mask)

def run(seed, iters):
    r = np.random.default_rng(seed)
    b = np.zeros(D, np.float32); b[:dept] = np.where(r.normal(size=dept) > 0, 2.0, -2.0)
    t0 = time.perf_counter()
    out = _learn_jit(Xd, xl, jnp.asarray(b), md,
                     jnp.asarray(1.0 / f, np.float32), jnp.asarray(1.0, np.float32),
                     jnp.asarray(1.0, np.float32), jnp.asarray(0.0, np.float32),
                     jnp.asarray(iters, jnp.int32), **kw)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, int(out[4])

# grow the span until it dwarfs dispatch jitter (a fixed short span can
# report rates above the card's peak)
iters_per_s = slope_rate(run, 32, 128, trials=3, grow_to_seconds=0.4)

print("RESULT " + json.dumps({
    "tier": os.environ.get("PLSSVM_MATMUL_PRECISION", "high"),
    "kernel": %(kernel)r,
    "iterations": int(svm.last_cg_info["iterations"]),
    "converged": bool(svm.last_cg_info["delta"] <= 1e-12 * svm.last_cg_info["delta0"]),
    "accuracy_pct": round(100.0 * acc, 3),
    "bias": float(svm.bias_),
    "alpha_norm": float(np.linalg.norm(svm.alphas)),
    "alphas_head": [float(a) for a in svm.alphas[:4]],
    "learn_s": round(learn_s, 4),
    "iters_per_s": round(iters_per_s, 2),
}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--f", type=int, default=256)
    ap.add_argument("--kernels", default="rbf,polynomial,linear")
    ap.add_argument("--tiers", default="highest,high,default")
    args = ap.parse_args()

    results = []
    for tier in args.tiers.split(","):
        for kernel in args.kernels.split(","):
            env = {**os.environ, "PLSSVM_MATMUL_PRECISION": tier}
            code = CHILD % {"repo": REPO, "n": args.n, "f": args.f,
                            "kernel": kernel}
            out = subprocess.run([sys.executable, "-c", code], env=env,
                                 capture_output=True, text=True, timeout=3000)
            line = next((l for l in out.stdout.splitlines()
                         if l.startswith("RESULT ")), None)
            if line is None:
                results.append({"tier": tier, "kernel": kernel,
                                "error": out.stderr[-500:]})
                print(f"{tier:8s} {kernel:11s} ERROR", flush=True)
                continue
            rec = json.loads(line[len("RESULT "):])
            results.append(rec)
            print(f"{tier:8s} {kernel:11s} iters={rec['iterations']:4d} "
                  f"acc={rec['accuracy_pct']:7.3f}% "
                  f"rate={rec['iters_per_s']:9.2f}/s "
                  f"bias={rec['bias']:+.6e}", flush=True)

    # deltas vs the highest tier
    base = {r["kernel"]: r for r in results
            if r.get("tier") == "highest" and "error" not in r}
    for r in results:
        b = base.get(r.get("kernel"))
        if b and "error" not in r:
            r["bias_delta_vs_highest"] = abs(r["bias"] - b["bias"])
            r["alpha_head_max_delta"] = max(
                abs(a - c) for a, c in zip(r["alphas_head"], b["alphas_head"]))
    print(json.dumps({"metric": "precision_frontier",
                      "n": args.n, "f": args.f, "results": results}))


if __name__ == "__main__":
    main()
