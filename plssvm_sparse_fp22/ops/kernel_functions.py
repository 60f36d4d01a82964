"""JAX kernel functions: linear, polynomial, RBF.

JAX equivalent of ``plssvm::kernel_function``
(``include/plssvm/kernel_types.hpp:69-84``) generalized from scalars to
blocks: the polynomial/RBF element-wise transforms are applied to Gram
*blocks* produced by a single GEMM, so XLA can fuse ``pow``/``exp`` into
the GEMM's consumer.

RBF uses the norm-expansion trick ``|x-y|^2 = |x|^2 + |y|^2 - 2<x,y>`` so the
distance matrix is also one GEMM (the reference's CUDA kernel instead
accumulates squared differences feature-by-feature, ``svm_kernel.cu:195-201``
— a pattern no GEMM library serves).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax import lax

from ..types import KernelType


def _resolve_precision():
    """Dot precision of every f32 Gram product.  On the H100, XLA runs an
    f32 dot at ``DEFAULT`` precision in TF32 on the tensor cores (about
    three decimal digits) and at ``HIGHEST`` in exact f32; the measured
    lowering of each tier is in docs/PERF.md ("Dot precision on the
    H100").  The CG solver needs f32-grade products, so ``HIGHEST`` is the
    default; ``PLSSVM_MATMUL_PRECISION=default`` trades accuracy for the
    tensor-core rate.  ``high`` is accepted but selects nothing new on the
    H100: it lowers to TF32 like ``default``."""
    name = os.environ.get("PLSSVM_MATMUL_PRECISION", "highest").lower()
    return {
        "highest": lax.Precision.HIGHEST,
        "high": lax.Precision.HIGH,
        "default": lax.Precision.DEFAULT,
        "fastest": lax.Precision.DEFAULT,
    }.get(name, lax.Precision.HIGHEST)


PRECISION = _resolve_precision()


def kernel_scalar(kernel: KernelType, xi, xj, degree=3, gamma=1.0, coef0=0.0):
    """k(xi, xj) for single vectors (used for QA_cost, ``csvm.cpp:243``)."""
    xi = jnp.asarray(xi)
    xj = jnp.asarray(xj)
    dot = jnp.dot(xi, xj, preferred_element_type=xi.dtype, precision=PRECISION)
    if kernel == KernelType.linear:
        return dot
    if kernel == KernelType.polynomial:
        return (gamma * dot + coef0) ** degree
    if kernel == KernelType.rbf:
        diff = xi - xj
        return jnp.exp(-gamma * jnp.dot(diff, diff, preferred_element_type=xi.dtype, precision=PRECISION))
    raise ValueError(f"unknown kernel {kernel}")


def _poly(G, degree, gamma, coef0):
    base = gamma * G + coef0
    # integer_pow for integral degrees keeps XLA on the fast path
    if float(degree) == int(degree):
        return lax.integer_pow(base, int(degree))
    return base ** degree


def kernel_diag(kernel: KernelType, sq, degree=3, gamma=1.0, coef0=0.0):
    """Kernel-matrix diagonal ``k(x_i, x_i)`` from squared norms — the ONE
    place this formula lives (Jacobi preconditioners, feature-sharded
    learn, sparse kii all route here)."""
    if kernel == KernelType.linear:
        return sq
    if kernel == KernelType.polynomial:
        return _poly(sq, degree, gamma, coef0)
    if kernel == KernelType.rbf:
        return jnp.ones_like(sq)
    raise ValueError(f"unknown kernel {kernel}")


def gram_block(
    kernel: KernelType,
    Xi,
    Xj,
    degree=3,
    gamma=1.0,
    coef0=0.0,
    Xi_sqnorm=None,
    Xj_sqnorm=None,
    precision=None,
):
    """K[a, b] = k(Xi[a], Xj[b]) for row blocks Xi (m, f), Xj (n, f).

    One GEMM plus a fused element-wise epilogue.  For RBF, pass
    precomputed squared norms to avoid recomputing them per block.
    ``precision`` overrides the module default dot tier (used by the
    adaptive CG solve, which runs the same block at two tiers).
    """
    G = jnp.dot(Xi, Xj.T, preferred_element_type=Xi.dtype,
                precision=PRECISION if precision is None else precision)
    if kernel == KernelType.linear:
        return G
    if kernel == KernelType.polynomial:
        return _poly(G, degree, gamma, coef0)
    if kernel == KernelType.rbf:
        if Xi_sqnorm is None:
            Xi_sqnorm = jnp.sum(Xi * Xi, axis=1)
        if Xj_sqnorm is None:
            Xj_sqnorm = jnp.sum(Xj * Xj, axis=1)
        sq = Xi_sqnorm[:, None] + Xj_sqnorm[None, :] - 2.0 * G
        return jnp.exp(-gamma * jnp.maximum(sq, 0.0))
    raise ValueError(f"unknown kernel {kernel}")


def gram_matrix(kernel: KernelType, X, Y=None, degree=3, gamma=1.0, coef0=0.0):
    """Full kernel matrix K[i, j] = k(X[i], Y[j]) (Y defaults to X)."""
    if Y is None:
        Y = X
    return gram_block(kernel, X, Y, degree, gamma, coef0)
