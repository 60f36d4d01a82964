"""Weak-scaling benchmark: CG iterations/s over a growing device mesh.

Weak-scaling efficiency of CG iterations/s over 1..p devices (four NVLink
GPUs on one host is the configuration this repo measures).  The implicit
kernel matvec is an O(D^2 f) operator, so "weak scaling" needs care:

- ``--scaling work`` (default): total rows grow with sqrt(devices), keeping
  the per-device per-iteration FLOPs approximately constant.  Because
  rows_local rounds to the block size, D_p^2/p is not exactly constant, so
  ``weak_efficiency`` is the work-normalized ratio
  ``(rate_p * D_p^2 / p) / (rate_1 * D_1^2 / p_1)`` — equal to
  rate_p / rate_1 whenever the rounding is exact.  This is the standard
  weak-scaling experiment for a quadratic operator.
- ``--scaling rows``: each device keeps a constant row block (the dataset
  grows linearly, the classic "bigger machine, bigger data" story), so the
  per-device work per iteration *doubles* with the device count.
  ``weak_efficiency`` here is work-normalized:
  ``(rate_p * D_p^2) / (p * rate_1 * D_1^2)`` — the per-device useful-FLOP
  rate relative to 1 device.

On ``--cpu`` the "devices" are virtual XLA host devices sharing ONE host's
cores, so even perfect code cannot exceed ``1/p`` efficiency — the CPU run
is a harness/regression check (the JSON says so); real numbers need real
GPUs, where the same command applies unchanged.

Timing uses the two-point-slope method (two iteration caps, fresh inputs)
to cancel dispatch and transfer overhead.
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def measure(mesh, rows_per_dev, f, kernel_name, mode, lo=4, hi=16,
            data="dense", density=0.05):
    import jax
    import jax.numpy as jnp

    from plssvm_sparse_fp22.parallel.sharded import make_sharded_learn, shard_system
    from plssvm_sparse_fp22.types import KernelType

    p = mesh.devices.size
    D = rows_per_dev * p
    dept = D - 8
    rng = np.random.default_rng(0)
    dtype = np.float32
    kernel = KernelType.from_string(kernel_name)

    from jax.sharding import NamedSharding, PartitionSpec as P
    from plssvm_sparse_fp22.parallel.mesh import DATA_AXIS

    row_sharding = NamedSharding(mesh, P(DATA_AXIS))

    if data == "sparse":
        import scipy.sparse as sp

        from plssvm_sparse_fp22.ops.sparse import (
            HybridSparse, TiledHybrid, stream_panel_rows,
            streaming_stream_strategy)
        from plssvm_sparse_fp22.parallel.sharded import (
            make_sharded_sparse_linear_learn,
            make_sharded_sparse_panel_learn,
            make_sharded_sparse_streaming_learn, shard_sparse_system,
            shard_sparse_tiled_system)

        csr = sp.random(dept, f, density=density, format="csr", dtype=dtype,
                        random_state=rng)
        x_last = rng.normal(size=f).astype(dtype)
        mask = np.zeros(D, dtype=dtype)
        mask[:dept] = 1.0
        kernel_scalars = (jnp.asarray(1.0 / f, dtype),
                          jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype))
        L_est = max(1, -(-csr.nnz // max(1, dept)))
        if kernel == KernelType.linear:
            h = HybridSparse.from_csr(csr, dtype=dtype, pad_rows=D)
            sys_args = shard_sparse_system(mesh, h, np.zeros(D, dtype), mask)
            learn = make_sharded_sparse_linear_learn(mesh)
            head, mask_dev = sys_args[:5], sys_args[6]
            tail_scalars = (jnp.asarray(1.0, dtype),)
        elif streaming_stream_strategy(L_est, f) == "panel":
            # what the product surface runs at this density: tiled slabs
            # ring the mesh, panels densify scatter-free per hop
            th = TiledHybrid.from_csr(csr, dtype=dtype, pad_rows=D)
            panel_rows = stream_panel_rows(
                D // p, th.tell.padded_features, 4, 8 * 1024**3)
            learn = make_sharded_sparse_panel_learn(
                mesh, kernel, 3, ntiles=th.tell.ntiles, Lt=th.tell.Lt,
                panel_rows=panel_rows)
            tv, tc, hv, hr, _b, mask_dev = shard_sparse_tiled_system(
                mesh, th, np.zeros(D, dtype), mask)
            head = (tv, tc, hv, hr)
            tail_scalars = kernel_scalars
        else:
            h = HybridSparse.from_csr(csr, dtype=dtype, pad_rows=D)
            sys_args = shard_sparse_system(mesh, h, np.zeros(D, dtype), mask)
            learn = make_sharded_sparse_streaming_learn(mesh, kernel, 3)
            head, mask_dev = sys_args[:5], sys_args[6]
            tail_scalars = kernel_scalars

        def run(seed, iters):
            r = np.random.default_rng(seed)
            b = np.zeros(D, dtype=dtype)
            b[:dept] = r.normal(size=dept)
            bs = jax.device_put(b, row_sharding)
            t0 = time.perf_counter()
            out = learn(*head, jnp.asarray(x_last), bs, mask_dev,
                        *tail_scalars, jnp.asarray(0.0, dtype),
                        jnp.asarray(iters, jnp.int32))
            jax.block_until_ready(out)
            return time.perf_counter() - t0, int(out[4])

        from plssvm_sparse_fp22.utils.timing import slope_rate

        return slope_rate(run, lo, hi, trials=3, grow_to_seconds=0.25), D

    X_pad = np.zeros((D, f), dtype=dtype)
    X_pad[:dept] = rng.normal(size=(dept, f))
    x_last = rng.normal(size=f).astype(dtype)
    mask = np.zeros(D, dtype=dtype)
    mask[:dept] = 1.0

    learn = make_sharded_learn(mesh, kernel, 3, mode)
    Xs, _, ms = shard_system(mesh, X_pad, np.zeros(D, dtype), mask)

    def run(seed, iters):
        r = np.random.default_rng(seed)
        b = np.zeros(D, dtype=dtype)
        # continuous rhs: a discrete +-2 pattern on a low-rank Gram can hit
        # delta == 0.0 exactly and stop the eps=0 CG before the cap
        b[:dept] = r.normal(size=dept)
        bs = jax.device_put(b, row_sharding)
        args = (Xs, jnp.asarray(x_last), bs, ms,
                jnp.asarray(1.0 / f, dtype), jnp.asarray(0.0, dtype),
                jnp.asarray(1.0, dtype), jnp.asarray(0.0, dtype),
                jnp.asarray(iters, jnp.int32))
        t0 = time.perf_counter()
        out = learn(*args)
        jax.block_until_ready(out)
        # (elapsed, executed): slope_rate divides by executed iterations,
        # correct even if the eps=0 CG hits an exact-zero residual early
        return time.perf_counter() - t0, int(out[4])

    from plssvm_sparse_fp22.utils.timing import slope_rate

    # grow the span until it dwarfs dispatch noise; median of 3 trials
    return slope_rate(run, lo, hi, trials=3, grow_to_seconds=0.25), D


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true", help="force CPU (harness check)")
    parser.add_argument("--rows-per-dev", type=int, default=1024,
                        help="row block per device at p=1 (scaled per --scaling)")
    parser.add_argument("--features", type=int, default=128)
    parser.add_argument("--kernel", default="rbf")
    parser.add_argument("--mode", default="implicit")
    parser.add_argument("--data", choices=("dense", "sparse"), default="dense",
                        help="sparse: ELL+COO shards (linear: psummed "
                             "feature product; poly/rbf: ring streaming)")
    parser.add_argument("--density", type=float, default=0.05)
    parser.add_argument("--scaling", choices=("work", "rows"), default="work",
                        help="work: constant per-device FLOPs (rows ~ sqrt(p)); "
                             "rows: constant rows per device (work ~ p)")
    args = parser.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.data == "sparse":
        # the sparse paths have one strategy per kernel (linear psum /
        # poly-rbf ring streaming); reflect what actually runs in the metric
        args.mode = "linear" if args.kernel == "linear" else "implicit"

    from plssvm_sparse_fp22.parallel.mesh import make_mesh

    n_dev = jax.device_count()
    sizes = [p for p in (1, 2, 4, 8, 16, 32) if p <= n_dev]
    rates, dims, eff = {}, {}, {}
    block = 8  # row blocks must stay divisible across the mesh
    for p in sizes:
        if args.scaling == "work":
            # per-device work / iter = rows_local * D = rows_per_dev^2 at p=1;
            # keep it constant: D = rows_per_dev * sqrt(p)
            rows_local = max(block, int(round(args.rows_per_dev * math.sqrt(p) / p / block)) * block)
        else:
            rows_local = args.rows_per_dev
        mesh = make_mesh(p)
        rate, D = measure(mesh, rows_local, args.features, args.kernel,
                          args.mode, data=args.data, density=args.density)
        rates[p], dims[p] = rate, D
        p0 = sizes[0]
        if args.scaling == "work":
            # constant per-device work -> perfect scaling = constant iters/s
            # (up to the rounding of rows_local to the block size)
            work_ratio = (rates[p] * dims[p] ** 2 / p) / (rates[p0] * dims[p0] ** 2 / p0)
            eff[p] = work_ratio
        else:
            eff[p] = (rates[p] * dims[p] ** 2) / (p * rates[p0] * dims[p0] ** 2)
        print(f"devices={p:3d} rows={D:7d} iters/s={rate:9.2f} "
              f"weak-eff={eff[p]:7.2%}", flush=True)

    data_tag = "" if args.data == "dense" else "_sparse"
    print(json.dumps({
        "metric": f"weak_scaling_{args.kernel}_{args.mode}{data_tag}_{args.scaling}",
        "platform": jax.default_backend(),
        "virtual_devices_share_host_cores": bool(args.cpu),
        "host_cores": os.cpu_count(),
        "note": (f"CPU harness check: p virtual devices share this host's "
                 f"{os.cpu_count()} cores, so the efficiency ceiling is "
                 f"~min(1, cores/p); run the same command on a real "
                 f"multi-GPU host for true weak scaling")
                if args.cpu else "real devices",
        "rows": dims,
        "features": args.features,
        "iters_per_s": rates,
        "weak_efficiency": eff,
    }))


if __name__ == "__main__":
    main()
