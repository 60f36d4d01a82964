"""Implicit kernel-matrix x vector product — the hot op of the CG solver.

JAX replacement for the reference's five ``svm_kernel``
implementations (``svm_kernel.cu:17-224``, ``OpenMP/svm_kernel.cpp:21-47``,
``svm_kernel.cl``, ``svm_kernel_nd_range.hpp`` ...).  The implicit matrix is

    A_ij = K_ij + QA_cost - q_i - q_j + (1/C) * delta_ij

over the first ``dept = n - 1`` points.  The reference fuses the rank-1
``QA_cost - q_i - q_j`` correction and the diagonal shift into its triangular
CUDA kernel with atomicAdd scatter; here the corrections are algebraically
hoisted out of the O(n^2) part entirely::

    A v = K v + (QA_cost * sum(v) - q.v) * mask - sum(v) * q + (1/C) * v

(with ``mask`` zeroing padding rows), so the O(n^2) work is a pure Gram
matvec that maps straight onto a GEMM — no atomics, no triangular
bookkeeping (SURVEY.md §2.4 item 2).

Three execution modes:

- ``linear``   — K v = X (X^T v): two skinny GEMMs, O(n f) per iteration.
  Asymptotically faster than the reference, which re-computes the full
  O(n^2 f) Gram product every CG iteration even for the linear kernel.
- ``cached``   — materialize K once in device memory (O(n^2)), then each
  CG iteration is a single GEMV at the memory-bandwidth roofline.  Chosen automatically when K
  fits in the configurable budget; a capability the GPU-memory-bound
  reference never had.
- ``implicit`` — stream row blocks of X through a blocked Gram matvec
  (``lax.map``), recomputing K on the fly: O(n f) memory, works for n far
  beyond device memory.  This is the reference's actual strategy.  A fused
  Pallas (Triton) kernel that never stores K was measured slower than this
  path on the H100 and removed (docs/PERF.md).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import ROW_BLOCK_SIZE
from ..types import KernelType
from .kernel_functions import PRECISION, gram_block


def _k_cache_budget_bytes() -> int:
    return int(os.environ.get("PLSSVM_K_CACHE_BYTES", 8 * 1024**3))


#: precision-tier names accepted by the adaptive plan / overrides.  What
#: XLA makes of each for an f32 dot on the H100 is recorded in
#: docs/PERF.md ("Dot precision on the H100"): ``high`` lowers to TF32
#: there like ``default``.
_TIER_PRECISION = {
    "default": lax.Precision.DEFAULT,
    "high": lax.Precision.HIGH,
    "highest": lax.Precision.HIGHEST,   # exact f32
}


def tier_precision(name: str):
    """Map a tier name to its ``lax.Precision``."""
    return _TIER_PRECISION[name]


def resolve_precision_plan(mode: str, dtype) -> tuple[str, str] | None:
    """Adaptive dot-precision plan for a learn: ``(fast_tier, acc_tier)``
    when the adaptive two-tier CG applies, else ``None`` (fixed tier).

    The adaptive CG (``solver/cg.cg_solve_adaptive``) runs on the fast tier
    and escalates to the accurate one if the accurate-tier residual misses
    the target.  It is off unless ``PLSSVM_MATMUL_PRECISION=adaptive``: on
    the H100 the fast tiers are TF32 or bf16 tensor-core products, and
    neither has yet been measured against the escalation fixture there
    (ROADMAP A1).  The accurate tier is ``highest``: on the H100 ``high``
    lowers to TF32 like ``default`` (docs/PERF.md), so it could not check
    the fast tier.  ``cached`` mode is bound by memory bandwidth (precision
    only touches the one-time K assembly) and f64 needs exact products, so
    neither takes the plan.
    """
    if os.environ.get("PLSSVM_MATMUL_PRECISION", "").lower() != "adaptive":
        return None
    if jnp.dtype(dtype) != jnp.float32 or mode not in ("implicit", "linear"):
        return None
    return ("default", "highest")


def choose_mode(kernel: KernelType, dept: int, dtype,
                budget_scale: int = 1) -> str:
    """Pick the execution mode (analog of ``determine_default_backend``,
    ``backend_types.cpp:51-74``, but over matvec strategies): ``cached``
    whenever K fits the budget: on the H100 one GEMV over a cached K beats
    recomputing K at every feature width above about 9 (the measured
    crossover is in docs/PERF.md).  ``budget_scale`` multiplies the
    K-cache budget (the sharded learn splits the cached-K slab over that
    many devices)."""
    if kernel == KernelType.linear:
        return "linear"
    itemsize = jnp.dtype(dtype).itemsize
    if dept * dept * itemsize <= _k_cache_budget_bytes() * budget_scale:
        return "cached"
    return "implicit"


def choose_sharded_mode(kernel: KernelType, dept: int, dtype,
                        ndev: int) -> str:
    """Mode selection for the row-sharded multi-device learn: one policy
    (:func:`choose_mode`) with the K-cache budget applied per device."""
    return choose_mode(kernel, dept, dtype, budget_scale=ndev)


def jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv):
    """Inverse diagonal of the implicit matrix from the kernel diagonal:
    A_ii = K_ii + QA_cost - 2 q_i + 1/C (``svm_kernel.cu:67-83`` with i=j).
    The ONE place the preconditioner formula lives — every learn path
    (dense, sparse, sharded) builds its ``kii`` and calls this."""
    diag = kii + QA_cost - 2.0 * q + cost_inv
    # A is SPD so diag > 0; guard against FP underflow on degenerate rows
    tiny = jnp.asarray(jnp.finfo(kii.dtype).tiny, kii.dtype)
    return mask / jnp.maximum(diag, tiny)


def jacobi_minv(kernel, X_pad, q, mask, QA_cost, cost_inv, degree, gamma, coef0):
    """:func:`jacobi_minv_from_kii` with ``kii`` computed from dense rows.

    Row-local, so the row-sharded path computes its shard's slice with the
    same code."""
    from .kernel_functions import kernel_diag

    sq = jnp.sum(X_pad * X_pad, axis=1)
    kii = kernel_diag(kernel, sq, degree, gamma, coef0)
    return jacobi_minv_from_kii(kii, q, mask, QA_cost, cost_inv)


@dataclass
class MatvecOperator:
    """A v callable plus the scalars the CG solver needs."""

    matvec: Callable  # (v: (D,)) -> (D,)
    q: jnp.ndarray  # (D,) padded with zeros
    mask: jnp.ndarray  # (D,) 1.0 on the first dept entries
    QA_cost: jnp.ndarray  # scalar
    cost_inv: jnp.ndarray  # scalar
    mode: str


def _corrections(Kv, v, q, mask, QA_cost, cost_inv):
    """Fold the rank-1 + diagonal corrections (``svm_kernel.cu:67-83``)."""
    s = jnp.sum(v)
    t = jnp.dot(q, v, preferred_element_type=v.dtype, precision=PRECISION)
    return mask * Kv + (QA_cost * s - t) * mask - s * q + cost_inv * v


def build_operator(
    kernel: KernelType,
    X_pad: jnp.ndarray,  # (D, f): first dept rows are data, rest zero
    q: jnp.ndarray,  # (D,) zero-padded
    mask: jnp.ndarray,  # (D,)
    QA_cost,
    cost_inv,
    *,
    degree: int = 3,
    gamma: float = 1.0,
    coef0: float = 0.0,
    mode: str | None = None,
    row_block: int = ROW_BLOCK_SIZE,
    precision=None,
) -> MatvecOperator:
    """Construct the implicit-A matvec for the padded system.

    ``precision`` overrides the dot tier of the per-iteration Gram products
    (``linear``/``implicit`` modes; the adaptive CG builds the same
    operator at two tiers).  ``None`` keeps the module defaults
    (``PLSSVM_MATMUL_PRECISION``)."""
    from ..utils.assertions import plssvm_assert

    D, _ = X_pad.shape
    plssvm_assert(q.shape == (D,) and mask.shape == (D,),
                  "operator vectors must match the padded system: q {} mask {} D {}",
                  q.shape, mask.shape, D)
    dtype = X_pad.dtype
    QA_cost = jnp.asarray(QA_cost, dtype)
    cost_inv = jnp.asarray(cost_inv, dtype)
    if mode is None:
        dept = int(mask.sum()) if isinstance(mask, (jnp.ndarray,)) else D
        mode = choose_mode(kernel, dept, dtype)

    gemm_prec = PRECISION if precision is None else precision

    if mode == "linear":
        if kernel != KernelType.linear:
            raise ValueError("mode='linear' requires the linear kernel")

        def matvec(v):
            # K v = X (X^T v): two GEMMs, never materializes K
            u = jnp.dot(X_pad.T, v, preferred_element_type=dtype, precision=gemm_prec)
            Kv = jnp.dot(X_pad, u, preferred_element_type=dtype, precision=gemm_prec)
            return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    elif mode == "cached":
        K = gram_block(kernel, X_pad, X_pad, degree, gamma, coef0)
        # zero the padding rows/cols once so the per-iteration GEMV needs no
        # masking of its own
        K = K * (mask[:, None] * mask[None, :])

        def matvec(v):
            Kv = jnp.dot(K, v, preferred_element_type=dtype, precision=PRECISION)
            return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    elif mode == "implicit":
        sqnorms = jnp.sum(X_pad * X_pad, axis=1)
        nb = D // row_block if D % row_block == 0 else None
        if nb is None:
            raise ValueError(f"padded size {D} not divisible by row block {row_block}")
        Xb = X_pad.reshape(nb, row_block, -1)
        sqb = sqnorms.reshape(nb, row_block)

        def matvec(v):
            def block_fn(args):
                Xi, sq_i = args
                Kblk = gram_block(
                    kernel, Xi, X_pad, degree, gamma, coef0,
                    Xi_sqnorm=sq_i, Xj_sqnorm=sqnorms,
                    precision=precision,
                )
                return jnp.dot(Kblk, v, preferred_element_type=dtype, precision=PRECISION)

            Kv = lax.map(block_fn, (Xb, sqb)).reshape(D)
            return _corrections(Kv, v, q, mask, QA_cost, cost_inv)

    else:
        raise ValueError(f"unknown matvec mode '{mode}'")

    return MatvecOperator(
        matvec=matvec, q=q, mask=mask, QA_cost=QA_cost, cost_inv=cost_inv, mode=mode
    )
