"""Worker process for the multi-host (DCN) tests.

Each of the two processes owns 4 virtual CPU devices; together they form one
8-device global mesh.  The worker feeds its local row block through
``make_global_row_sharded`` and runs the same sharded code paths that the
single-process tests use — the shard_map code cannot tell ICI from DCN, which
is the point (SURVEY.md §2.4 item 4).

Scenarios (the multi-host envelope beyond the reference's
single-node CI, ``.jenkins/Jenkinsfile-Tests-Multi-GPU:130-133``):

- ``dense``     — ring-implicit rbf learn, per-process row feeding.
- ``sparse``    — sparse gather-ring rbf learn over ELL+COO shards.
- ``predict``   — SV-sharded distributed predict (psummed decisions).
- ``ckpt_a``    — chunked learn, save a CG checkpoint at iteration 6, exit
                  (the "kill").
- ``ckpt_b``    — FRESH 2-process launch resumes from ``ckpt_a``'s file and
                  converges.

Usage: python _multihost_worker.py <coordinator> <num_procs> <proc_id>
       <outdir> [scenario]
"""

import os
import sys

coordinator, num_procs, proc_id, outdir = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
scenario = sys.argv[5] if len(sys.argv) > 5 else "dense"

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from plssvm_sparse_fp22.parallel.distributed import (  # noqa: E402
    initialize_distributed, make_global_row_sharded)
from plssvm_sparse_fp22.parallel.mesh import make_mesh  # noqa: E402
from plssvm_sparse_fp22.types import KernelType  # noqa: E402
from plssvm_sparse_fp22.utils import oracle  # noqa: E402

EPS, IMAX, COST = 1e-10, 200, 2.0
GAMMA, COEF0, DEGREE = 0.1, 1.0, 3
HYPER = dict(degree=DEGREE, gamma=GAMMA, coef0=COEF0)


def _dense_problem():
    rng = np.random.default_rng(7)
    n, f = 257, 12
    dept = n - 1
    D = 320  # 8 shards x 40 rows
    half = n // 2
    X = np.concatenate([
        rng.normal(loc=+1.0, size=(half, f)),
        rng.normal(loc=-1.0, size=(n - half, f)),
    ])
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]

    X_pad = np.zeros((D, f))
    X_pad[:dept] = X[:dept]
    b_pad = np.zeros(D)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D)
    mask[:dept] = 1.0
    return X, y, X_pad, b_pad, mask, dept, D


def _feed(mesh, *arrays):
    """Row-shard each global array by feeding ONLY this process's rows."""
    out = []
    for a in arrays:
        rows_per_proc = a.shape[0] // num_procs
        lo = proc_id * rows_per_proc
        out.append(make_global_row_sharded(mesh, a[lo:lo + rows_per_proc]))
    return out


def _check_sharded_x(x_sh, x_ref_pad):
    for shard in x_sh.addressable_shards:
        idx = shard.index[0]
        np.testing.assert_allclose(
            np.asarray(shard.data), x_ref_pad[idx], rtol=1e-4, atol=1e-4)


def scenario_dense(mesh):
    from plssvm_sparse_fp22.parallel.sharded import make_sharded_learn

    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    Xs, bs, ms = _feed(mesh, X_pad, b_pad, mask)
    learn = make_sharded_learn(mesh, KernelType.rbf, DEGREE, "implicit")
    x_sh, s, t, QA, iters, delta, delta0 = learn(
        Xs, jnp.asarray(X[-1]), bs, ms,
        jnp.float64(GAMMA), jnp.float64(COEF0), jnp.float64(COST),
        jnp.float64(EPS), jnp.int32(IMAX),
    )
    jax.block_until_ready(x_sh)

    alpha_ref, bias_ref, _ = oracle.solve_lssvm(
        X, y, kernel=KernelType.rbf, cost=COST, epsilon=EPS, max_iter=IMAX,
        **HYPER)
    x_ref_pad = np.zeros(D)
    x_ref_pad[:dept] = alpha_ref[:dept]
    _check_sharded_x(x_sh, x_ref_pad)

    bias = float(y[-1]) + float(QA) * float(s) - float(t)
    assert abs(bias - bias_ref) < 5e-3, (bias, bias_ref)
    assert float(delta) <= EPS * EPS * float(delta0) or int(iters) == IMAX
    return f"iters={int(iters)} bias={bias}\n"


def _sparse_problem():
    import scipy.sparse as sp

    rng = np.random.default_rng(13)
    n, f = 257, 24
    dept = n - 1
    D = 320
    csr = sp.random(n, f, density=0.25, format="csr", dtype=np.float64,
                    random_state=np.random.RandomState(13))
    csr = (csr + sp.eye(n, f, format="csr")).tocsr()  # no empty rows
    y = np.where(rng.normal(size=n) > 0, 1.0, -1.0)
    return csr, y, dept, D


def scenario_sparse(mesh):
    """Sparse gather-ring learn across processes: each chip holds only its
    ELL+COO shard; shards walk the ring over ICI AND the DCN cut."""
    from plssvm_sparse_fp22.ops.sparse import HybridSparse
    from plssvm_sparse_fp22.parallel.sharded import (
        make_sharded_sparse_streaming_learn)

    csr, y, dept, D = _sparse_problem()
    h = HybridSparse.from_csr(csr[:dept], dtype=np.float64, pad_rows=D)
    b_pad = np.zeros(D)
    b_pad[:dept] = y[:dept] - y[-1]
    mask = np.zeros(D)
    mask[:dept] = 1.0

    # tails grouped per shard exactly as shard_sparse_system does, then fed
    # per process (rows = shards)
    p = mesh.devices.size
    rows_per = D // p
    trows = np.asarray(h.coo_rows)
    sid = trows // rows_per if trows.size else np.zeros(0, np.int64)
    m_max = int(np.bincount(sid, minlength=p).max()) if trows.size else 0
    R = np.zeros((p, m_max), np.int32)
    C = np.zeros((p, m_max), np.int32)
    V = np.zeros((p, m_max), np.float64)
    for s_ in range(p):
        sel = sid == s_
        k = int(sel.sum())
        R[s_, :k] = trows[sel] - s_ * rows_per
        C[s_, :k] = np.asarray(h.coo_cols)[sel]
        V[s_, :k] = np.asarray(h.coo_vals)[sel]

    vals, cols, tr, tc, tv, bs, ms = _feed(
        mesh, np.asarray(h.ell.values), np.asarray(h.ell.cols), R, C, V,
        b_pad, mask)
    x_last = np.asarray(csr[-1].todense()).ravel()

    learn = make_sharded_sparse_streaming_learn(mesh, KernelType.rbf, DEGREE)
    x_sh, s, t, QA, iters, delta, delta0 = learn(
        vals, cols, tr, tc, tv, jnp.asarray(x_last), bs, ms,
        jnp.float64(GAMMA), jnp.float64(COEF0), jnp.float64(COST),
        jnp.float64(EPS), jnp.int32(IMAX),
    )
    jax.block_until_ready(x_sh)

    Xd = csr.toarray()
    alpha_ref, bias_ref, _ = oracle.solve_lssvm(
        Xd, y, kernel=KernelType.rbf, cost=COST, epsilon=EPS, max_iter=IMAX,
        **HYPER)
    x_ref_pad = np.zeros(D)
    x_ref_pad[:dept] = alpha_ref[:dept]
    _check_sharded_x(x_sh, x_ref_pad)
    bias = float(y[-1]) + float(QA) * float(s) - float(t)
    assert abs(bias - bias_ref) < 5e-3, (bias, bias_ref)
    return f"iters={int(iters)} bias={bias}\n"


def scenario_predict(mesh):
    """Distributed predict: SV axis sharded across both processes' devices,
    decision values psummed and replicated to every process."""
    from plssvm_sparse_fp22.parallel.sharded import make_sharded_predict

    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    alpha_ref, bias_ref, _ = oracle.solve_lssvm(
        X, y, kernel=KernelType.rbf, cost=COST, epsilon=EPS, max_iter=IMAX,
        **HYPER)
    n = len(y)
    Np = 264  # 8 shards x 33 rows
    X_sv = np.zeros((Np, X.shape[1]))
    X_sv[:n] = X
    a_sv = np.zeros(Np)
    a_sv[:n] = alpha_ref
    Xs, As = _feed(mesh, X_sv, a_sv)

    points = X[:16]
    predict = make_sharded_predict(mesh, KernelType.rbf, DEGREE)
    out = predict(jnp.asarray(points), Xs, As, jnp.float64(bias_ref),
                  jnp.float64(GAMMA), jnp.float64(COEF0))
    out = np.asarray(out)

    decision_ref = (oracle.kernel_matrix(KernelType.rbf, points, X, **HYPER)
                    @ alpha_ref + bias_ref)
    np.testing.assert_allclose(out, decision_ref, rtol=1e-8, atol=1e-8)
    return "predict ok " + " ".join(f"{v:.6f}" for v in out[:4]) + "\n"


def scenario_ckpt(mesh, phase):
    """Checkpoint across process lifetimes: phase a runs 6 iterations and
    saves the sharded CG state (gathered once, written by process 0); a
    FRESH launch (phase b) reconstructs the sharded state from the file and
    converges."""
    from jax.experimental import multihost_utils

    from plssvm_sparse_fp22.parallel.sharded import (
        make_sharded_learn_fns)
    from plssvm_sparse_fp22.solver.cg import CGState
    from plssvm_sparse_fp22.solver.checkpoint import (
        load_cg_checkpoint, save_cg_checkpoint)

    X, y, X_pad, b_pad, mask, dept, D = _dense_problem()
    Xs, bs, ms = _feed(mesh, X_pad, b_pad, mask)
    setup_jit, chunk_jit = make_sharded_learn_fns(
        mesh, KernelType.rbf, DEGREE, "implicit")
    scalars = (jnp.float64(GAMMA), jnp.float64(COEF0), jnp.float64(COST))
    path = os.path.join(outdir, "dcn_cg.npz")

    if phase == "a":
        q, QA, state = setup_jit(Xs, jnp.asarray(X[-1]), bs, ms, *scalars)
        state = chunk_jit(Xs, bs, ms, jnp.asarray(X[-1]), *scalars,
                          jnp.float64(EPS), jnp.int32(6), state)
        assert int(state.k) == 6
        # gather the sharded vectors once for the host-side checkpoint
        gathered = CGState(
            k=state.k,
            x=multihost_utils.process_allgather(state.x, tiled=True),
            r=multihost_utils.process_allgather(state.r, tiled=True),
            d=multihost_utils.process_allgather(state.d, tiled=True),
            delta=state.delta, delta0=state.delta0)
        q_full = multihost_utils.process_allgather(q, tiled=True)
        if proc_id == 0:
            save_cg_checkpoint(path, gathered, q_full, QA,
                               {"dept": dept, "kernel": int(KernelType.rbf)})
        multihost_utils.sync_global_devices("ckpt_saved")
        return f"saved at k={int(state.k)}\n"

    loaded = load_cg_checkpoint(path)
    assert loaded is not None, "phase a checkpoint missing"
    state_np, q_np, QA, meta = loaded
    assert int(meta["dept"]) == dept
    x_sh, r_sh, d_sh = _feed(mesh, np.asarray(state_np.x),
                             np.asarray(state_np.r), np.asarray(state_np.d))
    state = CGState(k=jnp.asarray(state_np.k), x=x_sh, r=r_sh, d=d_sh,
                    delta=jnp.asarray(state_np.delta),
                    delta0=jnp.asarray(state_np.delta0))
    state = chunk_jit(Xs, bs, ms, jnp.asarray(X[-1]), *scalars,
                      jnp.float64(EPS), jnp.int32(IMAX), state)
    assert int(state.k) > 6
    assert float(state.delta) <= EPS * EPS * float(state.delta0)

    alpha_ref, bias_ref, _ = oracle.solve_lssvm(
        X, y, kernel=KernelType.rbf, cost=COST, epsilon=EPS, max_iter=IMAX,
        **HYPER)
    x_ref_pad = np.zeros(D)
    x_ref_pad[:dept] = alpha_ref[:dept]
    _check_sharded_x(state.x, x_ref_pad)
    return f"resumed to k={int(state.k)}\n"


def main():
    ok = initialize_distributed(coordinator_address=coordinator,
                                num_processes=num_procs, process_id=proc_id)
    assert ok, "distributed runtime failed to initialize"
    assert jax.process_count() == num_procs
    assert jax.device_count() == 4 * num_procs

    mesh = make_mesh()  # all 8 global devices
    if scenario == "dense":
        msg = scenario_dense(mesh)
    elif scenario == "sparse":
        msg = scenario_sparse(mesh)
    elif scenario == "predict":
        msg = scenario_predict(mesh)
    elif scenario == "ckpt_a":
        msg = scenario_ckpt(mesh, "a")
    elif scenario == "ckpt_b":
        msg = scenario_ckpt(mesh, "b")
    else:
        raise SystemExit(f"unknown scenario {scenario}")

    with open(os.path.join(outdir, f"ok_{proc_id}"), "w") as fh:
        fh.write(msg)


if __name__ == "__main__":
    main()
