"""Sparse-data training paths (CSR-retained).

Selected by :meth:`CSVM.learn` when the parsed data's density is below
``Parameter.sparse_threshold``:

- linear kernel: fully implicit ELL+COO matvec CG on device
  (``K v = X (X^T v)`` with nnz-proportional products, ``ops/sparse.py``),
- polynomial/RBF, three memory-guarded tiers (``models/base.py
  _learn_sparse``): (1) Gram assembled once → cached GEMV CG; (2) densify
  X only → the implicit matvec; (3) streaming CG from the
  ELL+COO packing at O(n·L) memory when even dense X exceeds the budget
  (:func:`learn_sparse_implicit_jit`, the north-star regime).

The reference has no equivalent: it always densifies
(``parameter.hpp:51-75``) and would exhaust memory on wide sparse data.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.kernel_functions import PRECISION
from ..ops.matvec import _corrections
from ..ops.sparse import ELLMatrix
from ..solver.cg import cg_solve
from ..types import KernelType


from ..ops.matvec import jacobi_minv_from_kii as _diag_minv  # one formula


@partial(jax.jit, static_argnames=("f", "precond"))
def learn_sparse_linear_jit(vals, cols, coo_rows, coo_cols, coo_vals,
                            x_last_dense, b_pad, mask, cost, eps, imax,
                            *, f, precond: str = "none"):
    """Linear-kernel learn over the ELL+COO hybrid packing; O(nnz) per CG
    iteration, robust to skewed row fills (one dense row no longer inflates
    every row's ELL padding)."""
    from ..ops.sparse import (HybridSparse, hybrid_matvec, hybrid_rmatvec,
                              hybrid_row_sqnorms)

    dtype = vals.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost
    h = HybridSparse(
        ell=ELLMatrix(values=vals, cols=cols, shape=(vals.shape[0], f)),
        coo_rows=coo_rows, coo_cols=coo_cols, coo_vals=coo_vals,
    )

    q = hybrid_matvec(h, x_last_dense) * mask
    QA_cost = jnp.dot(
        x_last_dense, x_last_dense, preferred_element_type=dtype, precision=PRECISION
    ) + cost_inv

    def matvec(v):
        u = hybrid_rmatvec(h, v)  # X^T v : scatter into feature space
        Kv = hybrid_matvec(h, u)  # X u   : gather back to rows
        return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    minv = None
    if precond == "jacobi":
        minv = _diag_minv(hybrid_row_sqnorms(h), q, mask, QA_cost, cost_inv)
    res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
    s = jnp.sum(res.x)
    t = jnp.dot(q, res.x, preferred_element_type=dtype, precision=PRECISION)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0


@partial(jax.jit, static_argnames=(
    "kernel", "degree", "ntiles", "Lt", "panel_rows", "precond",
    "heavy_rows", "precision_plan", "sweep"))
def learn_sparse_panel_jit(tvals, tlcols, x_last_dense, b_pad, mask,
                           gamma, coef0, cost, eps, imax, *, kernel, degree,
                           ntiles, Lt, panel_rows, precond: str = "none",
                           heavy=None, heavy_rows: tuple = (),
                           heavy_sq_vec=None, heavy_g_vec=None,
                           precision_plan: tuple | None = None,
                           sweep: str | None = None):
    """Streaming sparse poly/rbf learn, ``panel`` strategy — CG over the
    implicit kernel matrix recomputed per iteration from the tiled-ELL
    packing via transient scatter-free densified panels, one GEMM and
    kernel function per panel pair: O(n·ntiles·Lt) resident memory, no (n, n) Gram, no full
    (n, f) densification (the north star; BASELINE.json config 3).  The
    reference cannot run this regime at all (always densifies,
    ``parameter.hpp:51-75``).

    ``sweep`` picks the pair-sweep schedule (``windowed`` = the
    bounded-liveness i-major scan serving the physically-beyond-HBM
    regime, ``unrolled`` = the memory-hungry fast schedule); ``None``
    resolves :func:`~..ops.sparse.panel_sweep_strategy` at trace time —
    callers that may be re-invoked under a different
    ``PLSSVM_SPARSE_PANEL_SWEEP`` must pass it explicitly (the jit cache
    keys on the argument, not the env).  ``precision_plan`` enables the adaptive
    two-tier CG on the panel-pair products (same contract as the dense
    ``_learn_jit``)."""
    from ..ops.sparse import (make_tiled_panel_matvec,
                              make_tiled_panel_matvec_windowed,
                              panel_sweep_strategy, sparse_q_qa_kii,
                              tiled_matvec)

    dtype = tvals.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost
    nP = -(-tvals.shape[0] // panel_rows)
    if sweep is None:
        sweep = panel_sweep_strategy(nP * (nP + 1) // 2)
    maker = (make_tiled_panel_matvec_windowed if sweep == "windowed"
             else make_tiled_panel_matvec)

    def make_kv(prec):
        return maker(
            tvals, tlcols, int(kernel), degree, gamma, coef0,
            ntiles=ntiles, Lt=Lt, panel_rows=panel_rows,
            heavy=heavy, heavy_rows=heavy_rows, heavy_sq_vec=heavy_sq_vec,
            precision=prec)

    if precision_plan is not None:
        from ..ops.matvec import tier_precision

        kv_fast, sq = make_kv(tier_precision(precision_plan[0]))
        kv_acc, _ = make_kv(tier_precision(precision_plan[1]))
    else:
        kv_fn, sq = make_kv(None)
        kv_fast = kv_acc = None

    f = x_last_dense.shape[0]
    fp = ntiles * 128
    x_last_p = (x_last_dense if f == fp
                else jnp.zeros((fp,), dtype).at[:f].set(x_last_dense))
    g_last = tiled_matvec(tvals, tlcols, x_last_p, ntiles, Lt)
    if heavy_g_vec is not None:
        g_last = g_last + heavy_g_vec  # heavy rows' <x_i, x_last>, host-built
    sq_last = jnp.dot(x_last_dense, x_last_dense,
                      preferred_element_type=dtype, precision=PRECISION)
    q, QA_cost, kii = sparse_q_qa_kii(
        int(kernel), degree, gamma, coef0, g_last, sq_last, sq, mask, cost_inv)

    minv = None
    if precond == "jacobi":
        minv = _diag_minv(kii, q, mask, QA_cost, cost_inv)

    if kv_fast is not None:
        from ..solver.cg import cg_solve_adaptive

        def mv_fast(v):
            return _corrections(kv_fast(v), v, q, mask, QA_cost, cost_inv)

        def mv_acc(v):
            return _corrections(kv_acc(v), v, q, mask, QA_cost, cost_inv)

        res = cg_solve_adaptive(mv_fast, mv_acc, b_pad, mask, eps, imax,
                                minv=minv)
        k_fast = res.fast_iterations
    else:
        def matvec(v):
            return _corrections(kv_fn(v), v, q, mask, QA_cost, cost_inv)

        res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
        k_fast = res.iterations
    s = jnp.sum(res.x)
    t = jnp.dot(q, res.x, preferred_element_type=dtype, precision=PRECISION)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0, k_fast


@partial(jax.jit, static_argnames=("kernel", "degree", "f", "precond", "bm", "bn"))
def learn_sparse_implicit_jit(vals, cols, coo_rows, coo_cols, coo_vals,
                              x_last_dense, b_pad, mask, gamma, coef0, cost,
                              eps, imax, *, kernel, degree, f,
                              precond: str = "none", bm=None, bn=None):
    """Streaming sparse poly/rbf learn, ``gather`` strategy — CG over the
    implicit kernel matrix recomputed blockwise from the ELL+COO packing
    every iteration with the nnz-proportional gather contraction: O(n·L)
    memory, no (n, n) Gram, no (n, f) densification.  The extreme-sparsity
    arm of the streaming tier (moderate densities ride
    :func:`learn_sparse_panel_jit`)."""
    from ..ops.sparse import (HybridSparse, ELLMatrix, hybrid_matvec,
                              make_streaming_gram_matvec)

    dtype = vals.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost
    h = HybridSparse(
        ell=ELLMatrix(values=vals, cols=cols, shape=(vals.shape[0], f)),
        coo_rows=coo_rows, coo_cols=coo_cols, coo_vals=coo_vals,
    )
    kv_fn, sq = make_streaming_gram_matvec(
        h, int(kernel), degree, gamma, coef0, bm=bm, bn=bn)

    from ..ops.sparse import sparse_q_qa_kii

    g_last = hybrid_matvec(h, x_last_dense)  # <x_i, x_last>
    sq_last = jnp.dot(x_last_dense, x_last_dense,
                      preferred_element_type=dtype, precision=PRECISION)
    q, QA_cost, kii = sparse_q_qa_kii(
        int(kernel), degree, gamma, coef0, g_last, sq_last, sq, mask, cost_inv)

    def matvec(v):
        return _corrections(kv_fn(v), v, q, mask, QA_cost, cost_inv)

    minv = None
    if precond == "jacobi":
        minv = _diag_minv(kii, q, mask, QA_cost, cost_inv)
    res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
    s = jnp.sum(res.x)
    t = jnp.dot(q, res.x, preferred_element_type=dtype, precision=PRECISION)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0


def _transform_gram(kernel: KernelType, G, sq, degree, gamma, coef0):
    """Kernel transform of a precomputed Gram matrix (diag = squared norms)."""
    if kernel == KernelType.linear:
        return G
    if kernel == KernelType.polynomial:
        return jax.lax.integer_pow(gamma * G + coef0, degree)
    if kernel == KernelType.rbf:
        d2 = sq[:, None] + sq[None, :] - 2.0 * G
        return jnp.exp(-gamma * jnp.maximum(d2, 0.0))
    raise ValueError(f"unknown kernel {kernel}")


@partial(jax.jit, static_argnames=("kernel", "degree", "precond"))
def learn_from_gram_jit(G_pad, sq, q_lin, qa_lin, b_pad, mask,
                        gamma, coef0, cost, eps, imax, *, kernel, degree,
                        precond: str = "none"):
    """Cached-mode learn from a host-assembled linear Gram matrix.

    ``G_pad`` is (D, D) with ``G[i, j] = <x_i, x_j>`` over the first dept
    rows (zero padding elsewhere); ``sq`` its diagonal extended with the
    squared norms, ``q_lin[i] = <x_i, x_last>``, ``qa_lin = <x_last,
    x_last>``.  The kernel transform and all CG iterations run on device.
    """
    dtype = G_pad.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost

    if kernel == KernelType.polynomial:
        q = jax.lax.integer_pow(gamma * q_lin + coef0, degree) * mask
        QA_cost = jax.lax.integer_pow(gamma * qa_lin + coef0, degree) + cost_inv
    elif kernel == KernelType.rbf:
        d2 = sq + qa_lin - 2.0 * q_lin
        q = jnp.exp(-gamma * jnp.maximum(d2, 0.0)) * mask
        QA_cost = jnp.asarray(1.0, dtype) + cost_inv  # exp(0)
    else:
        q = q_lin * mask
        QA_cost = qa_lin + cost_inv

    K = _transform_gram(kernel, G_pad, sq, degree, gamma, coef0)
    K = K * (mask[:, None] * mask[None, :])

    def matvec(v):
        Kv = jnp.dot(K, v, preferred_element_type=dtype, precision=PRECISION)
        return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    minv = None
    if precond == "jacobi":
        minv = _diag_minv(jnp.diagonal(K), q, mask, QA_cost, cost_inv)
    res = cg_solve(matvec, b_pad, mask, eps, imax, minv=minv)
    s = jnp.sum(res.x)
    t = jnp.dot(q, res.x, preferred_element_type=dtype, precision=PRECISION)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0


@partial(jax.jit, static_argnames=("kernel", "degree"))
def predict_from_cross_gram_jit(Gc, sq_points, sq_sv, alphas, bias,
                                gamma, coef0, *, kernel, degree):
    """Predict from a host-assembled cross Gram ``Gc[p, i] = <point_p, x_i>``."""
    K = _transform_gram_cross(kernel, Gc, sq_points, sq_sv, degree, gamma, coef0)
    return jnp.dot(K, alphas, preferred_element_type=Gc.dtype, precision=PRECISION) + bias


def _transform_gram_cross(kernel, Gc, sq_a, sq_b, degree, gamma, coef0):
    if kernel == KernelType.linear:
        return Gc
    if kernel == KernelType.polynomial:
        return jax.lax.integer_pow(gamma * Gc + coef0, degree)
    if kernel == KernelType.rbf:
        d2 = sq_a[:, None] + sq_b[None, :] - 2.0 * Gc
        return jnp.exp(-gamma * jnp.maximum(d2, 0.0))
    raise ValueError(f"unknown kernel {kernel}")
