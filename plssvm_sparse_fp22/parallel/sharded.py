"""Multi-chip LS-SVM training: row-sharded implicit matvec + collective CG.

JAX replacement for the reference's multi-GPU scheme.  The reference
splits the *feature* axis across devices for the linear kernel only
(``gpu_csvm.cpp:130-157``), pins polynomial/RBF to one GPU
(``CUDA/csvm.cu:61-63``), and combines partial results with a host-staged
all-reduce (``device_reduction``, ``gpu_csvm.cpp:366-386``: sync, D2H copy,
host add, H2D broadcast — every CG iteration).  Here the *row* axis is
sharded over a 1-D ``jax.sharding.Mesh`` and every exchange is an XLA
collective over ICI/DCN inside one compiled program:

- **linear**    — ``K v = X (X^T v)``: each chip computes the partial
  feature-space product ``X_loc^T v_loc`` and one ``psum`` (2f floats)
  replicates it; the row product stays local.  Communication volume per CG
  iteration is O(f), independent of n.
- **cached**    — K is row-sharded (each chip holds a (D/p, D) slab);
  ``all_gather`` of v (D floats) then a local GEMV.
- **implicit (ring)** — the flagship HBM-scaling path: each chip holds only
  its (D/p, f) row block.  The Gram matvec walks the ring with
  ``lax.ppermute``: at step s the chip multiplies its rows against the block
  it just received, accumulates ``f(X_loc X_recv^T) v_recv``, and forwards
  the block.  Peak memory is 2 row blocks per device; comms overlap the
  work.  This is the blockwise/ring long-context pattern applied to a Gram
  operator (SURVEY.md §5) and removes the reference's "device 0 owns the
  rank-1 correction" trick (``svm_kernel.cu:67-71``) — corrections are
  algebraically hoisted out, as in the single-chip path.

CG dot products are ``psum`` of local partials — a fixed, deterministic
reduction order (the float-reproducibility hard part (a) of SURVEY.md §7;
the reference has to *emulate* its blocked summation order in tests,
``tests/backends/compare.cpp:34-48``).

Multi-host: the same code runs over a DCN-connected mesh after
``jax.distributed.initialize`` — ``shard_map`` doesn't care which links
carry the collective.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.kernel_functions import PRECISION, gram_block, kernel_scalar
from ..types import KernelType
from .mesh import DATA_AXIS


def _psum_dot(a, b):
    """Deterministic distributed dot: local partial + psum."""
    return lax.psum(jnp.dot(a, b, preferred_element_type=a.dtype, precision=PRECISION), DATA_AXIS)


def _local_corrections(Kv_loc, v_loc, q_loc, mask_loc, QA_cost, cost_inv):
    """Shard-local rank-1 + diagonal corrections (two psummed scalars) —
    the sharded twin of ``ops/matvec._corrections``, shared by every
    sharded matvec (dense and sparse)."""
    s = lax.psum(jnp.sum(v_loc), DATA_AXIS)
    t = _psum_dot(q_loc, v_loc)
    return (
        mask_loc * Kv_loc
        + (QA_cost * s - t) * mask_loc
        - s * q_loc
        + cost_inv * v_loc
    )


def _build_local_matvec(kernel, X_loc, q_loc, mask_loc, QA_cost, cost_inv,
                        degree, gamma, coef0, mode, K_loc=None, precision=None):
    """Per-shard A@v: v_loc (D/p,) -> (A v)_loc (D/p,), collectives inside.

    ``precision`` overrides the dot tier of the per-iteration products
    (``linear``/``implicit`` modes) — the adaptive two-tier CG builds the
    same local matvec at two tiers, exactly like the single-device
    ``build_operator``."""
    dtype = X_loc.dtype
    num = lax.axis_size(DATA_AXIS)
    gemm_prec = PRECISION if precision is None else precision

    def corrections(Kv_loc, v_loc):
        return _local_corrections(Kv_loc, v_loc, q_loc, mask_loc,
                                  QA_cost, cost_inv)

    if mode == "linear":

        def matvec(v_loc):
            u = lax.psum(jnp.dot(X_loc.T, v_loc, preferred_element_type=dtype, precision=gemm_prec), DATA_AXIS)
            Kv_loc = jnp.dot(X_loc, u, preferred_element_type=dtype, precision=gemm_prec)
            return corrections(Kv_loc, v_loc)

    elif mode == "cached":

        def matvec(v_loc):
            v_full = lax.all_gather(v_loc, DATA_AXIS, tiled=True)
            Kv_loc = jnp.dot(K_loc, v_full, preferred_element_type=dtype, precision=PRECISION)
            return corrections(Kv_loc, v_loc)

    elif mode == "implicit":
        sq_loc = jnp.sum(X_loc * X_loc, axis=1)
        right = [(i, (i + 1) % num) for i in range(num)]

        def block_product(X_buf, sq_buf, v_buf):
            Kblk = gram_block(
                kernel, X_loc, X_buf, degree, gamma, coef0,
                Xi_sqnorm=sq_loc, Xj_sqnorm=sq_buf,
                precision=precision,
            )
            return jnp.dot(Kblk, v_buf, preferred_element_type=dtype,
                           precision=PRECISION)

        def matvec(v_loc):
            def step(carry, _):
                X_buf, sq_buf, v_buf, acc = carry
                acc = acc + block_product(X_buf, sq_buf, v_buf)
                X_buf = lax.ppermute(X_buf, DATA_AXIS, right)
                sq_buf = lax.ppermute(sq_buf, DATA_AXIS, right)
                v_buf = lax.ppermute(v_buf, DATA_AXIS, right)
                return (X_buf, sq_buf, v_buf, acc), None

            init = (X_loc, sq_loc, v_loc, jnp.zeros_like(v_loc))
            (X_b, sq_b, v_b, Kv_loc), _ = lax.scan(step, init, None, length=num)
            return corrections(Kv_loc, v_loc)

    else:
        raise ValueError(f"unknown sharded matvec mode '{mode}'")

    return matvec


def _prepare_local(kernel, X_loc, x_last, mask_loc, gamma, coef0, cost,
                   degree, mode, precond, precision=None):
    """Shared per-shard setup: q slice, QA_cost, the local matvec, and the
    optional Jacobi preconditioner slice.  Every sharded learn variant
    (full / setup / chunk) goes through here so there is exactly one
    operator construction, mirroring the single ``build_operator`` of the
    one-chip path.  ``precision`` overrides the matvec's dot tier (the
    adaptive CG's fast tier; q/QA/K assembly stay at the default)."""
    dtype = X_loc.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost
    # q_i = k(x_i, x_last): purely local (x_last replicated)
    q_loc = gram_block(kernel, X_loc, x_last[None, :], degree, gamma, coef0)[:, 0]
    q_loc = q_loc * mask_loc
    QA_cost = kernel_scalar(kernel, x_last, x_last, degree, gamma, coef0) + cost_inv

    K_loc = None
    if mode == "cached":
        # row slab of K against the full (all-gathered) data
        X_full = lax.all_gather(X_loc, DATA_AXIS, tiled=True)
        mask_full = lax.all_gather(mask_loc, DATA_AXIS, tiled=True)
        K_loc = gram_block(kernel, X_loc, X_full, degree, gamma, coef0)
        K_loc = K_loc * (mask_loc[:, None] * mask_full[None, :])

    matvec = _build_local_matvec(
        kernel, X_loc, q_loc, mask_loc, QA_cost, cost_inv,
        degree, gamma, coef0, mode, K_loc=K_loc, precision=precision,
    )
    minv = None
    if precond == "jacobi":
        from ..ops.matvec import jacobi_minv

        minv = jacobi_minv(kernel, X_loc, q_loc, mask_loc, QA_cost, cost_inv,
                           degree, gamma, coef0)
    return q_loc, QA_cost, cost_inv, matvec, minv


def _prepare_feature_local(kernel, X_loc, x_last_loc, mask, gamma, coef0,
                           cost, degree, precond):
    """Shared per-shard setup for the FEATURE-sharded learns: psummed
    q/QA_cost, the psum-assembled Gram matvec, and the optional Jacobi
    slice.  CG vectors are replicated in this scheme, so everything
    returned is replicated; the one collective per matvec is the partial
    Gram psum.  The feature twin of :func:`_prepare_local`."""
    from ..constants import ROW_BLOCK_SIZE

    dtype = X_loc.dtype
    D = X_loc.shape[0]
    cost_inv = jnp.asarray(1.0, dtype) / cost

    # q and QA_cost from psummed partial linear terms
    # (generate_q + device_reduction, gpu_csvm.cpp:160-183)
    g_last = lax.psum(
        jnp.dot(X_loc, x_last_loc, preferred_element_type=dtype, precision=PRECISION),
        DATA_AXIS,
    )
    sq_last = lax.psum(jnp.dot(x_last_loc, x_last_loc,
                               preferred_element_type=dtype, precision=PRECISION),
                       DATA_AXIS)
    sq_loc = lax.psum(jnp.sum(X_loc * X_loc, axis=1), DATA_AXIS)

    if kernel == KernelType.linear:
        q = g_last
        QA = sq_last
    elif kernel == KernelType.polynomial:
        q = (gamma * g_last + coef0) ** degree
        QA = (gamma * sq_last + coef0) ** degree
    else:  # rbf
        q = jnp.exp(-gamma * jnp.maximum(sq_loc + sq_last - 2.0 * g_last, 0.0))
        QA = jnp.asarray(1.0, dtype)
    q = q * mask
    QA_cost = QA + cost_inv

    def corrections(Kv, v):
        s = jnp.sum(v)
        t = jnp.dot(q, v, preferred_element_type=dtype, precision=PRECISION)
        return mask * Kv + (QA_cost * s - t) * mask - s * q + cost_inv * v

    if kernel == KernelType.linear:

        def matvec(v):
            u = jnp.dot(X_loc.T, v, preferred_element_type=dtype, precision=PRECISION)
            Kv = lax.psum(
                jnp.dot(X_loc, u, preferred_element_type=dtype, precision=PRECISION),
                DATA_AXIS,
            )
            return corrections(Kv, v)

    else:
        # blockwise psum-assembled Gram rows + post-collective transform
        nb = D // ROW_BLOCK_SIZE if (D % ROW_BLOCK_SIZE == 0 and D >= ROW_BLOCK_SIZE) else 1
        Xb = X_loc.reshape(nb, D // nb, -1)
        sqb = sq_loc.reshape(nb, D // nb)

        def matvec(v):
            def block_fn(args):
                Xi, sq_i = args
                G_blk = lax.psum(
                    jnp.dot(Xi, X_loc.T, preferred_element_type=dtype,
                            precision=PRECISION),
                    DATA_AXIS,
                )
                if kernel == KernelType.polynomial:
                    K_blk = (gamma * G_blk + coef0) ** degree
                else:
                    d2 = sq_i[:, None] + sq_loc[None, :] - 2.0 * G_blk
                    K_blk = jnp.exp(-gamma * jnp.maximum(d2, 0.0))
                return jnp.dot(K_blk, v, preferred_element_type=dtype,
                               precision=PRECISION)

            Kv = lax.map(block_fn, (Xb, sqb)).reshape(D)
            return corrections(Kv, v)

    minv = None
    if precond == "jacobi":
        from ..ops.kernel_functions import kernel_diag
        from ..ops.matvec import jacobi_minv_from_kii

        kii = kernel_diag(kernel, sq_loc, degree, gamma, coef0)
        minv = jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)

    return q, QA_cost, cost_inv, matvec, minv


@lru_cache(maxsize=None)
def make_feature_sharded_learn(mesh: Mesh, kernel: KernelType, degree: int,
                               precond: str = "none"):
    """Multi-chip learn with the **feature axis** sharded — the reference's
    own multi-GPU decomposition (``feature_ranges_``, ``gpu_csvm.cpp:130-157``)
    kept as an option for very wide data (SURVEY.md §2.4 item 3).

    Each chip holds a column slice ``X_loc`` (D, f/p); the Gram matvec is the
    psum of partial products ``K v = sum_p X_p (X_p^T v)`` — one O(D)
    collective per iteration, the XLA-native replacement for the reference's
    host-staged ``device_reduction`` (``gpu_csvm.cpp:366-386``).  CG vectors
    are replicated, so the BLAS-1 needs no collectives at all, and the
    "device 0 owns the rank-1 correction" trick (``svm_kernel.cu:67-71``)
    disappears: corrections are applied identically on every chip after the
    psum.

    The reference supports this split for the **linear kernel only** and pins
    polynomial/RBF to one GPU (``CUDA/csvm.cu:61-63``).  Here poly/RBF work
    too: their Gram matrix depends on features only through the linear Gram
    ``G = sum_p X_p X_p^T``, so each row block psums its partial ``G`` block
    and applies the kernel transform post-collective — O(D^2/blocks) comm per
    block sweep, worthwhile only when f/p dwarfs D (the wide-sparse regime
    this mode exists for).

    Returns ``fn(X_feat, x_last_feat, b, mask, gamma, coef0, cost, eps, imax)``
    with X/x_last feature-sharded and the vectors replicated; outputs are
    replicated.
    """
    from ..solver.cg import cg_solve

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(None), P(None),
                  P(), P(), P(), P(), P()),
        out_specs=(P(None), P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def run(X_loc, x_last_loc, b, mask, gamma, coef0, cost, eps, imax):
        dtype = X_loc.dtype
        q, QA_cost, _ci, matvec, minv = _prepare_feature_local(
            kernel, X_loc, x_last_loc, mask, gamma, coef0, cost, degree,
            precond,
        )
        res = cg_solve(matvec, b, mask, eps, imax, minv=minv)
        s = jnp.sum(res.x)
        t = jnp.dot(q, res.x, preferred_element_type=dtype, precision=PRECISION)
        return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0

    return jax.jit(run)


@lru_cache(maxsize=None)
def make_feature_sharded_learn_fns(mesh: Mesh, kernel: KernelType,
                                   degree: int, precond: str = "none"):
    """Chunked FEATURE-sharded learn: ``(setup, chunk)`` jits for the
    checkpoint / verbose-CG driver — the feature-axis twin of
    :func:`make_sharded_learn_fns` (per-iteration output / resume exists
    on every reference path, ``gpu_csvm.cpp:245-247``).
    CG vectors are replicated in this scheme, so the CGState is replicated
    and checkpoints interchange with the single-chip format.

    ``setup(X_feat, x_last_feat, b, mask, gamma, coef0, cost)
    -> (q, QA_cost, state)``; ``chunk(X_feat, b, mask, x_last_feat, gamma,
    coef0, cost, eps, imax_end, state) -> state``.
    """
    from ..solver.cg import CGState, cg_init, cg_run

    state_specs = CGState(k=P(), x=P(), r=P(), d=P(), delta=P(), delta0=P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS), P(DATA_AXIS), P(None), P(None),
                  P(), P(), P()),
        out_specs=(P(None), P(), state_specs),
        check_vma=False,
    )
    def setup(X_loc, x_last_loc, b, mask, gamma, coef0, cost):
        q, QA_cost, _ci, matvec, minv = _prepare_feature_local(
            kernel, X_loc, x_last_loc, mask, gamma, coef0, cost, degree,
            precond,
        )
        state = cg_init(matvec, b, mask, minv=minv)
        return q, QA_cost, state

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS), P(None), P(None), P(DATA_AXIS),
                  P(), P(), P(), P(), P(), state_specs),
        out_specs=state_specs,
        check_vma=False,
    )
    def chunk(X_loc, b, mask, x_last_loc, gamma, coef0, cost, eps,
              imax_end, state):
        _q, _QA, _ci, matvec, minv = _prepare_feature_local(
            kernel, X_loc, x_last_loc, mask, gamma, coef0, cost, degree,
            precond,
        )
        return cg_run(matvec, b, mask, eps, imax_end, state, minv=minv)

    return jax.jit(setup), jax.jit(chunk)


def shard_system_feature(mesh: Mesh, X_pad, x_last, b_pad, mask):
    """Place the padded system on the mesh (features sharded, vectors
    replicated) — the reference's ``feature_ranges_`` layout."""
    ndev = mesh.devices.size
    if X_pad.shape[1] % ndev != 0:
        raise ValueError(
            f"feature count {X_pad.shape[1]} must divide evenly over the "
            f"{ndev}-device mesh for feature sharding; pad the feature axis "
            f"to a multiple of {ndev} first"
        )
    col_sharding = NamedSharding(mesh, P(None, DATA_AXIS))
    feat_sharding = NamedSharding(mesh, P(DATA_AXIS))
    rep = NamedSharding(mesh, P())
    return (
        jax.device_put(X_pad, col_sharding),
        jax.device_put(x_last, feat_sharding),
        jax.device_put(b_pad, rep),
        jax.device_put(mask, rep),
    )


@lru_cache(maxsize=None)
def make_sharded_learn(mesh: Mesh, kernel: KernelType, degree: int, mode: str,
                       precond: str = "none",
                       precision_plan: tuple | None = None):
    """Build the jitted multi-chip learn step for a given mesh/config.

    Returns ``fn(X_pad, x_last, b_pad, mask, gamma, coef0, cost, eps, imax)
    -> (x, s, t, QA_cost, iterations, delta, delta0[, fast_iterations])``
    where the (D, f) data and (D,) vectors are sharded over the mesh's data
    axis (the 8th output exists only under ``precision_plan``).

    ``precond='jacobi'`` enables the diagonal preconditioner, and
    ``precision_plan`` the adaptive two-tier CG — the same feature set as the
    single-chip CG (the reference has one ``solver_CG`` for every backend,
    ``gpu_csvm.cpp:186-324``; so does this build).
    """
    from ..solver.cg import cg_solve, cg_solve_adaptive

    out_specs = (P(DATA_AXIS),) + (P(),) * (7 if precision_plan else 6)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    def run(X_loc, x_last, b_loc, mask_loc, gamma, coef0, cost, eps, imax):
        dtype = X_loc.dtype
        if precision_plan is None:
            q_loc, QA_cost, _ci, matvec, minv = _prepare_local(
                kernel, X_loc, x_last, mask_loc, gamma, coef0, cost,
                degree, mode, precond,
            )
            res = cg_solve(matvec, b_loc, mask_loc, eps, imax, minv=minv,
                           dot=_psum_dot)
            extra = ()
        else:
            from ..ops.matvec import tier_precision

            q_loc, QA_cost, cost_inv, mv_fast, minv = _prepare_local(
                kernel, X_loc, x_last, mask_loc, gamma, coef0, cost,
                degree, mode, precond,
                precision=tier_precision(precision_plan[0]),
            )
            mv_acc = _build_local_matvec(
                kernel, X_loc, q_loc, mask_loc, QA_cost, cost_inv,
                degree, gamma, coef0, mode,
                precision=tier_precision(precision_plan[1]),
            )
            res = cg_solve_adaptive(mv_fast, mv_acc, b_loc, mask_loc, eps,
                                    imax, minv=minv, dot=_psum_dot)
            extra = (res.fast_iterations,)

        s = lax.psum(jnp.sum(res.x), DATA_AXIS)
        t = _psum_dot(q_loc, res.x)
        return (res.x, s, t, QA_cost, res.iterations, res.delta,
                res.delta0) + extra

    return jax.jit(run)


@lru_cache(maxsize=None)
def make_sharded_learn_fns(mesh: Mesh, kernel: KernelType, degree: int,
                           mode: str, precond: str = "none"):
    """Chunked multi-chip learn: ``(setup, chunk)`` jits for the
    checkpoint / verbose-CG driver (the sharded twin of ``_cg_setup_jit`` /
    ``_cg_chunk_jit`` in ``models/base.py``), sharing ``_prepare_local``
    and the one CG in ``solver/cg.py``.

    ``setup(X, x_last, b, mask, gamma, coef0, cost) -> (q, QA_cost, state)``
    with ``q`` and the state vectors row-sharded, scalars replicated;
    ``chunk(X, b, mask, x_last, gamma, coef0, cost, eps, imax_end, state)
    -> state`` continues CG to ``imax_end`` total iterations.  ``chunk``
    rebuilds q/QA from ``x_last`` (cheap, avoids spec plumbing for passing
    the sharded q back in).
    """
    from ..solver.cg import CGState, cg_init, cg_run

    state_specs = CGState(k=P(), x=P(DATA_AXIS), r=P(DATA_AXIS),
                          d=P(DATA_AXIS), delta=P(), delta0=P())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P()),
        out_specs=(P(DATA_AXIS), P(), state_specs),
        check_vma=False,
    )
    def setup(X_loc, x_last, b_loc, mask_loc, gamma, coef0, cost):
        q_loc, QA_cost, _ci, matvec, minv = _prepare_local(
            kernel, X_loc, x_last, mask_loc, gamma, coef0, cost,
            degree, mode, precond,
        )
        state = cg_init(matvec, b_loc, mask_loc, minv=minv, dot=_psum_dot)
        return q_loc, QA_cost, state

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS), P(),
                  P(), P(), P(), P(), P(), state_specs),
        out_specs=state_specs,
        check_vma=False,
    )
    def chunk(X_loc, b_loc, mask_loc, x_last, gamma, coef0, cost, eps,
              imax_end, state):
        _q, _QA, _ci, matvec, minv = _prepare_local(
            kernel, X_loc, x_last, mask_loc, gamma, coef0, cost,
            degree, mode, precond,
        )
        return cg_run(matvec, b_loc, mask_loc, eps, imax_end, state,
                      minv=minv, dot=_psum_dot)

    return jax.jit(setup), jax.jit(chunk)


@lru_cache(maxsize=None)
def make_sharded_predict(mesh: Mesh, kernel: KernelType, degree: int):
    """Multi-chip predict: the support-vector axis is sharded, each chip
    expands its slice of the kernel sum, and one psum replicates the
    decision values — the XLA-native form of the reference's device-resident
    multi-buffer predict (``gpu_csvm.cpp:52-127``, ``predict_kernel.cu:32-77``
    whose atomicAdd scatter a psum replaces).

    Returns ``fn(points, X_sv, alphas, bias, gamma, coef0) -> (npoints,)``
    with ``points`` replicated, ``X_sv``/``alphas`` row-sharded (zero-padded
    rows are harmless: their alphas are zero).
    """

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(points, X_loc, alpha_loc, bias, gamma, coef0):
        K = gram_block(kernel, points, X_loc, degree, gamma, coef0)
        part = jnp.dot(K, alpha_loc, preferred_element_type=points.dtype,
                       precision=PRECISION)
        return lax.psum(part, DATA_AXIS) + bias

    return jax.jit(run)


@lru_cache(maxsize=None)
def make_sharded_w(mesh: Mesh):
    """Multi-chip ``w = X^T alpha`` (linear predict fast path,
    ``gpu_csvm.cpp:327-350``): each chip contracts its row slice, one psum
    of f floats replicates w."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    def run(X_loc, alpha_loc):
        return lax.psum(
            jnp.dot(X_loc.T, alpha_loc, preferred_element_type=X_loc.dtype,
                    precision=PRECISION),
            DATA_AXIS,
        )

    return jax.jit(run)


def shard_system(mesh: Mesh, X_pad, b_pad, mask):
    """Place the padded system on the mesh (rows sharded)."""
    row_sharding = NamedSharding(mesh, P(DATA_AXIS))
    mat_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return (
        jax.device_put(X_pad, mat_sharding),
        jax.device_put(b_pad, row_sharding),
        jax.device_put(mask, row_sharding),
    )


def shard_sparse_system(mesh: Mesh, h, b_pad, mask):
    """Place a padded ELL+COO hybrid system on the mesh (rows sharded).

    The ELL slabs shard naturally by row.  The COO overflow tail is split by
    owning shard with row indices rebased shard-locally and padded to a
    uniform per-shard count (padding entries have value 0, so they are
    inert).  Returns ``(vals, cols, trow, tcol, tval, b, mask)`` device
    arrays ready for :func:`make_sharded_sparse_linear_learn`.
    """
    p = mesh.devices.size
    n = h.ell.shape[0]
    if n % p != 0:
        raise ValueError(f"padded rows {n} must divide over the {p}-device mesh")
    rows_per = n // p
    trows = np.asarray(h.coo_rows)
    tcols = np.asarray(h.coo_cols)
    tvals = np.asarray(h.coo_vals)
    dtype = tvals.dtype
    sid = trows // rows_per if trows.size else np.zeros(0, np.int64)
    # m_max == 0 when the ELL cap absorbed every nonzero: the learns then
    # skip all tail scatters statically (has_*_tail is shape-based)
    m_max = int(np.bincount(sid, minlength=p).max()) if trows.size else 0
    R = np.zeros((p, m_max), np.int32)
    C = np.zeros((p, m_max), np.int32)
    V = np.zeros((p, m_max), dtype)
    for s in range(p):
        sel = sid == s
        k = int(sel.sum())
        R[s, :k] = trows[sel] - s * rows_per
        C[s, :k] = tcols[sel]
        V[s, :k] = tvals[sel]

    row_sharding = NamedSharding(mesh, P(DATA_AXIS))
    mat_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return (
        jax.device_put(h.ell.values, mat_sharding),
        jax.device_put(h.ell.cols, mat_sharding),
        jax.device_put(R, mat_sharding),
        jax.device_put(C, mat_sharding),
        jax.device_put(V, mat_sharding),
        jax.device_put(b_pad, row_sharding),
        jax.device_put(mask, row_sharding),
    )


def shard_sparse_tiled_system(mesh: Mesh, th, b_pad, mask):
    """Place a padded :class:`~..ops.sparse.TiledHybrid` system on the mesh
    (rows sharded) for the panel-strategy streaming ring.  The heavy-row
    spill is grouped by owning shard and padded to a uniform per-shard
    count (invalid slots carry the out-of-range row index ``m_loc``, so
    the in-shard placement skips them).  Returns
    ``(tvals, tlcols, heavy, hrow, b, mask)``."""
    p = mesh.devices.size
    tell = th.tell
    n = tell.vals.shape[0]
    if n % p != 0:
        raise ValueError(f"padded rows {n} must divide over the {p}-device mesh")
    m_loc = n // p
    fp = tell.padded_features

    hidx = np.asarray(th.heavy_idx)
    heavy_np = np.asarray(th.heavy)
    sid = hidx // m_loc if hidx.size else np.zeros(0, np.int64)
    h_max = int(np.bincount(sid, minlength=p).max()) if hidx.size else 0
    H = np.zeros((p, h_max, fp), heavy_np.dtype if hidx.size else tell.vals.dtype)
    R = np.full((p, h_max), m_loc, np.int32)  # m_loc = inert sentinel
    for s in range(p):
        sel = sid == s
        k = int(sel.sum())
        H[s, :k] = heavy_np[sel]
        R[s, :k] = (hidx[sel] - s * m_loc).astype(np.int32)

    row_sharding = NamedSharding(mesh, P(DATA_AXIS))
    mat_sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    mat3_sharding = NamedSharding(mesh, P(DATA_AXIS, None, None))
    return (
        jax.device_put(tell.vals, mat_sharding),
        jax.device_put(tell.lcols, mat_sharding),
        jax.device_put(H, mat3_sharding),
        jax.device_put(R, mat_sharding),
        jax.device_put(b_pad, row_sharding),
        jax.device_put(mask, row_sharding),
    )


@lru_cache(maxsize=None)
def make_sharded_sparse_panel_learn(mesh: Mesh, kernel: KernelType,
                                    degree: int, *, ntiles: int, Lt: int,
                                    panel_rows: int, sweep: str = "unrolled",
                                    precond: str = "none"):
    """Ring-sharded streaming poly/rbf learn over tiled-ELL shards with the
    ``panel`` contraction — the beyond-device-memory sparse regime on a
    mesh (BASELINE.json config 5) at GEMM rate: each device holds only its
    (D/p, ntiles·Lt) tiled slab; per CG iteration the slabs walk the ring
    (``lax.ppermute`` — tiled slabs, ~``2·Lt/128`` of the dense ring's
    bytes) and each hop densifies budget-sized row panels scatter-free
    (``ops/sparse.densify_tiled``) and runs one Gram-matvec per panel
    pair, exactly like the dense ring hop.  Peak memory is two tiled
    slabs + two transient dense panels per device; the kernel
    matrix and the full dense X never materialize.

    ``sweep`` (:func:`~..ops.sparse.panel_sweep_strategy`) picks how a hop
    walks its ``nP^2`` panel products: ``unrolled`` traces each inline
    (each in-flight panel densified once, by CSE); ``windowed`` scans the
    in-flight panels, densifying each once, and maps over the local
    panels, so one product is traced whatever the panel count.

    Returns ``fn(tvals, tlcols, heavy, hrow, x_last_dense, b, mask, gamma,
    coef0, cost, eps, imax)`` with system arrays sharded as produced by
    :func:`shard_sparse_tiled_system` (``heavy``/``hrow`` carry each
    shard's dense heavy-row spill; inert slots point at row ``m_loc``).
    """
    from ..ops.sparse import densify_tiled, sparse_q_qa_kii, tiled_matvec
    from ..solver.cg import cg_solve

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                  P(), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=(P(DATA_AXIS), P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def run(tvals, tlcols, heavy3, hrow2, x_last, b_loc, mask_loc,
            gamma, coef0, cost, eps, imax):
        dtype = tvals.dtype
        f = x_last.shape[0]
        fp = ntiles * 128
        m_loc = tvals.shape[0]
        heavy = heavy3[0].astype(dtype)  # (h_max, fp) local heavy rows
        hrow = hrow2[0]  # (h_max,) local row indices (m_loc = inert)
        h_max = heavy.shape[0]
        cost_inv = jnp.asarray(1.0, dtype) / cost
        num = lax.axis_size(DATA_AXIS)
        bounds = list(range(0, m_loc, panel_rows)) + [m_loc]
        nP = len(bounds) - 1

        x_last_p = (x_last if f == fp
                    else jnp.zeros((fp,), dtype).at[:f].set(x_last))
        sq_loc = jnp.sum(tvals * tvals, axis=1)
        g_last = tiled_matvec(tvals, tlcols, x_last_p, ntiles, Lt)
        if h_max:
            # heavy-row O(m) contributions, scatter-free via a one-hot
            # contraction (inert slots point past m_loc and match nothing)
            rows_iota = jax.lax.broadcasted_iota(jnp.int32, (h_max, m_loc), 1)
            onehot = (hrow[:, None] == rows_iota).astype(dtype)
            sq_loc = sq_loc + onehot.T @ jnp.sum(heavy * heavy, axis=1)
            g_last = g_last + onehot.T @ (heavy @ x_last_p)
        sq_last = jnp.dot(x_last, x_last, preferred_element_type=dtype,
                          precision=PRECISION)
        q_loc, QA_cost, kii = sparse_q_qa_kii(
            int(kernel), degree, gamma, coef0, g_last, sq_last, sq_loc,
            mask_loc, cost_inv)

        def densify(v, c, hv, hr, lo, rows):
            """Dense rows ``[lo, lo + rows)`` of a tiled slab plus its heavy
            rows; ``lo`` may be traced."""
            zero = jnp.asarray(0, jnp.int32)
            lo = jnp.asarray(lo, jnp.int32)
            base = densify_tiled(
                lax.dynamic_slice(v, (lo, zero), (rows, v.shape[1])),
                lax.dynamic_slice(c, (lo, zero), (rows, c.shape[1])),
                ntiles, Lt)
            for k in range(h_max):
                # traced positions (the in-flight shard's heavy rows differ
                # per hop): gated read-modify-write row slice, no scatter
                idx = jnp.clip(hr[k] - lo, 0, rows - 1).astype(jnp.int32)
                in_rng = jnp.logical_and(hr[k] >= lo, hr[k] < lo + rows)
                cur = lax.dynamic_slice(base, (idx, zero), (1, base.shape[1]))
                row = jnp.where(in_rng, hv[k:k + 1], cur)
                base = lax.dynamic_update_slice(base, row, (idx, zero))
            return base

        def panel_product(XdI, XdJ, sqJ, vJ):
            Kblk = gram_block(kernel, XdI, XdJ, degree, gamma, coef0,
                              Xj_sqnorm=sqJ)
            return jnp.dot(Kblk, vJ, preferred_element_type=dtype,
                           precision=PRECISION)

        if sweep == "windowed":
            # uniform panels: the slabs and vectors ride the ring padded to
            # nP * panel_rows rows (zero rows with zero v add nothing)
            m_pad = nP * panel_rows

            def pad_rows(a):
                return jnp.pad(a, ((0, m_pad - m_loc),) + ((0, 0),) * (a.ndim - 1))

            tvals_r, tlcols_r = pad_rows(tvals), pad_rows(tlcols)
            # the local side never rides the ring: densify it once
            local_stack = lax.map(
                lambda I: densify(tvals_r, tlcols_r, heavy, hrow,
                                  I * panel_rows, panel_rows),
                jnp.arange(nP, dtype=jnp.int32))

            def hop_contrib(bv, bc, bhv, bhr, bsq, vb):
                """Local rows x in-flight slab: scan the in-flight panels
                and map each over the local ones."""
                def j_step(acc, J):
                    lo = J * panel_rows
                    XdJ = densify(bv, bc, bhv, bhr, lo, panel_rows)
                    sqJ = lax.dynamic_slice(bsq, (lo,), (panel_rows,))
                    vJ = lax.dynamic_slice(vb, (lo,), (panel_rows,))
                    parts = lax.map(
                        lambda XdI: panel_product(XdI, XdJ, sqJ, vJ),
                        local_stack)
                    return acc + parts.reshape(m_pad), None

                acc, _ = lax.scan(j_step, jnp.zeros((m_pad,), dtype),
                                  jnp.arange(nP, dtype=jnp.int32))
                return acc[:m_loc]
        else:
            tvals_r, tlcols_r = tvals, tlcols

            def pad_rows(a):
                return a

            # the LOCAL side's densified panels are hop-invariant
            # (tvals/heavy never ride the ring): densify them ONCE outside
            # the ring scan instead of leaning on XLA LICM to hoist
            # num_hops*nP redundant densifies out of the scan body
            local_panels = [
                densify(tvals, tlcols, heavy, hrow, bounds[I],
                        bounds[I + 1] - bounds[I])
                for I in range(nP)
            ]

            def hop_contrib(bv, bc, bhv, bhr, bsq, vb):
                """Local rows x in-flight slab: densify the in-flight
                side's panels on the fly (scatter-free) and sum the panel
                products against the pre-densified local panels."""
                outs = []
                for I in range(nP):
                    loI, hiI = bounds[I], bounds[I + 1]
                    acc = jnp.zeros((hiI - loI,), dtype)
                    for J in range(nP):
                        loJ, hiJ = bounds[J], bounds[J + 1]
                        XdJ = densify(bv, bc, bhv, bhr, loJ, hiJ - loJ)
                        acc = acc + panel_product(local_panels[I], XdJ,
                                                  bsq[loJ:hiJ], vb[loJ:hiJ])
                    outs.append(acc)
                return jnp.concatenate(outs) if nP > 1 else outs[0]

        right = [(i, (i + 1) % num) for i in range(num)]

        def matvec(v_loc):
            def step(carry, _):
                bv, bc, bhv, bhr, bsq, vb, acc = carry
                acc = acc + hop_contrib(bv, bc, bhv, bhr, bsq, vb)
                bv, bc, bhv, bhr, bsq, vb = (
                    lax.ppermute(x, DATA_AXIS, right)
                    for x in (bv, bc, bhv, bhr, bsq, vb))
                return (bv, bc, bhv, bhr, bsq, vb, acc), None

            init = (tvals_r, tlcols_r, heavy, hrow, pad_rows(sq_loc),
                    pad_rows(v_loc), jnp.zeros_like(v_loc))
            (*_, Kv_loc), _ = lax.scan(step, init, None, length=num)
            return _local_corrections(Kv_loc, v_loc, q_loc, mask_loc,
                                      QA_cost, cost_inv)

        minv = None
        if precond == "jacobi":
            from ..ops.matvec import jacobi_minv_from_kii

            minv = jacobi_minv_from_kii(kii, q_loc, mask_loc, QA_cost,
                                        cost_inv)

        res = cg_solve(matvec, b_loc, mask_loc, eps, imax, minv=minv,
                       dot=_psum_dot)
        s = lax.psum(jnp.sum(res.x), DATA_AXIS)
        t = _psum_dot(q_loc, res.x)
        return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0

    return jax.jit(run)


@lru_cache(maxsize=None)
def make_sharded_sparse_streaming_learn(mesh: Mesh, kernel: KernelType,
                                        degree: int, precond: str = "none"):
    """Ring-sharded streaming poly/rbf learn over ELL+COO shards with the
    nnz-proportional ``gather`` contraction — the extreme-sparsity arm of
    the HBM-exceeding sparse regime on a mesh (BASELINE.json config 5):
    each chip holds only its (D/p, L) slab; per CG iteration the shards
    walk the ring (``lax.ppermute``) and each hop runs the streaming
    cross-Gram contraction (:func:`ops.sparse.make_streaming_cross_contrib`)
    of local rows against the in-flight shard.  Peak memory is two sparse
    shards per chip; the kernel matrix, dense X, and even a dense shard
    never materialize.  Moderate densities ride
    :func:`make_sharded_sparse_panel_learn` instead (GEMM-rate panels).

    Returns ``fn(vals, cols, trow, tcol, tval, x_last_dense, b, mask,
    gamma, coef0, cost, eps, imax)`` with system arrays sharded as produced
    by :func:`shard_sparse_system`.
    """
    from ..ops.sparse import make_streaming_cross_contrib
    from ..solver.cg import cg_solve

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=(P(DATA_AXIS), P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def run(vals, cols, trow, tcol, tval, x_last, b_loc, mask_loc,
            gamma, coef0, cost, eps, imax):
        dtype = vals.dtype
        f = x_last.shape[0]
        m_loc, L = vals.shape
        trow_l, tcol_l, tval_l = trow[0], tcol[0], tval[0]
        cost_inv = jnp.asarray(1.0, dtype) / cost
        num = lax.axis_size(DATA_AXIS)

        from ..ops.sparse import sparse_q_qa_kii

        sq_loc = jnp.sum(vals * vals, axis=1) + jax.ops.segment_sum(
            tval_l * tval_l, trow_l, num_segments=m_loc)
        # q_i = k(x_i, x_last): sparse row x dense vector, then transform
        g_last = jnp.sum(vals * x_last[cols], axis=1) + jax.ops.segment_sum(
            tval_l * x_last[tcol_l], trow_l, num_segments=m_loc)
        sq_last = jnp.dot(x_last, x_last, preferred_element_type=dtype,
                          precision=PRECISION)
        q_loc, QA_cost, kii = sparse_q_qa_kii(
            int(kernel), degree, gamma, coef0, g_last, sq_last, sq_loc,
            mask_loc, cost_inv)

        # largest tile dividing the shard (the product path pads shards to
        # PAD_SIZE multiples; expert callers may feed smaller shards)
        bm = next(b for b in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
                  if m_loc % b == 0)
        # cap the panel tile: the (bm, L, bn) gather intermediate scales
        # with bn, and this strategy only runs in the memory-exhausted
        # extreme-sparsity regime
        bn = min(bm, 128)
        contrib = make_streaming_cross_contrib(
            int(kernel), degree, gamma, coef0,
            row_vals=vals, row_cols=cols, row_sq=sq_loc,
            row_trow=trow_l, row_tcol=tcol_l, row_tval=tval_l,
            f=f, bm=bm, bn=bn, strategy="gather",
        )
        right = [(i, (i + 1) % num) for i in range(num)]

        def matvec(v_loc):
            def step(carry, _):
                pv, pc, ptr, ptc, ptv, psq, vb, acc = carry
                acc = acc + contrib(pv, pc, ptr, ptc, ptv, psq, vb)
                pv, pc, ptr, ptc, ptv, psq, vb = (
                    lax.ppermute(x, DATA_AXIS, right)
                    for x in (pv, pc, ptr, ptc, ptv, psq, vb))
                return (pv, pc, ptr, ptc, ptv, psq, vb, acc), None

            init = (vals, cols, trow_l, tcol_l, tval_l, sq_loc, v_loc,
                    jnp.zeros_like(v_loc))
            (*_, Kv_loc), _ = lax.scan(step, init, None, length=num)
            return _local_corrections(Kv_loc, v_loc, q_loc, mask_loc,
                                      QA_cost, cost_inv)

        minv = None
        if precond == "jacobi":
            from ..ops.matvec import jacobi_minv_from_kii

            minv = jacobi_minv_from_kii(kii, q_loc, mask_loc, QA_cost, cost_inv)

        res = cg_solve(matvec, b_loc, mask_loc, eps, imax, minv=minv,
                       dot=_psum_dot)
        s = lax.psum(jnp.sum(res.x), DATA_AXIS)
        t = _psum_dot(q_loc, res.x)
        return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0

    return jax.jit(run)


@lru_cache(maxsize=None)
def make_sharded_sparse_linear_learn(mesh: Mesh, precond: str = "none"):
    """Row-sharded sparse linear-kernel learn over the ELL+COO hybrid
    packing — the sparse twin of the dense ``linear`` sharded mode, for
    datasets whose *sparse* form spans multiple chips (BASELINE.json
    config 5 regime).  Beyond the reference, whose multi-GPU path is dense
    + feature-split + linear-only (``gpu_csvm.cpp:130-157``).

    Each chip holds its (D/p, L) ELL slab and shard-local COO tail; per CG
    iteration ``u = psum(X_loc^T v_loc)`` (f floats over ICI/DCN) then
    ``Kv_loc = X_loc u`` — nnz-proportional work per chip, O(f) comms.

    Returns ``fn(vals, cols, trow, tcol, tval, x_last_dense, b, mask, cost,
    eps, imax) -> (x, s, t, QA_cost, iterations, delta, delta0)`` with the
    system arrays sharded as produced by :func:`shard_sparse_system`.
    """
    from ..solver.cg import cg_solve

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
                  P(), P(DATA_AXIS), P(DATA_AXIS),
                  P(), P(), P()),
        out_specs=(P(DATA_AXIS), P(), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    def run(vals, cols, trow, tcol, tval, x_last, b_loc, mask_loc,
            cost, eps, imax):
        dtype = vals.dtype
        f = x_last.shape[0]
        m_loc = vals.shape[0]
        trow_l, tcol_l, tval_l = trow[0], tcol[0], tval[0]
        cost_inv = jnp.asarray(1.0, dtype) / cost

        def mv(u):  # X_loc @ u : (f,) -> (D/p,)
            out = jnp.sum(vals * u[cols], axis=1)
            return out + jax.ops.segment_sum(tval_l * u[tcol_l], trow_l,
                                             num_segments=m_loc)

        def rmv(v_loc):  # X_loc^T v_loc : (D/p,) -> (f,) partial
            out = jax.ops.segment_sum((vals * v_loc[:, None]).ravel(),
                                      cols.ravel(), num_segments=f)
            return out + jax.ops.segment_sum(tval_l * v_loc[trow_l], tcol_l,
                                             num_segments=f)

        q_loc = mv(x_last) * mask_loc
        QA_cost = jnp.dot(x_last, x_last, preferred_element_type=dtype,
                          precision=PRECISION) + cost_inv

        def matvec(v_loc):
            u = lax.psum(rmv(v_loc), DATA_AXIS)
            return _local_corrections(mv(u), v_loc, q_loc, mask_loc,
                                      QA_cost, cost_inv)

        minv = None
        if precond == "jacobi":
            from ..ops.matvec import jacobi_minv_from_kii

            # linear kernel: kii = row squared norms (ELL + COO tail)
            sq_loc = jnp.sum(vals * vals, axis=1) + jax.ops.segment_sum(
                tval_l * tval_l, trow_l, num_segments=m_loc)
            minv = jacobi_minv_from_kii(sq_loc, q_loc, mask_loc,
                                        QA_cost, cost_inv)

        res = cg_solve(matvec, b_loc, mask_loc, eps, imax, minv=minv,
                       dot=_psum_dot)
        s = lax.psum(jnp.sum(res.x), DATA_AXIS)
        t = _psum_dot(q_loc, res.x)
        return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0

    return jax.jit(run)
