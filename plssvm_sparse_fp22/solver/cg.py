"""Conjugate gradients under ``jax.jit`` with data-dependent iteration count.

JAX equivalent of ``gpu_csvm::solver_CG``
(``src/plssvm/backends/gpu_csvm.cpp:186-324``) and
``openmp::csvm::solver_CG`` (``OpenMP/csvm.cpp:82-170``), with identical
semantics:

- start vector ``x = 1`` (on the valid entries),
- stop when ``delta <= eps^2 * delta0`` (``gpu_csvm.cpp:293``),
- at most ``imax`` iterations (= ``num_features``, ``csvm.cpp:256``),
- full residual recompute ``r = b - A x`` every 50th iteration
  (``OpenMP/csvm.cpp:130-139``; the reference GPU path drops the device-0
  contribution in this branch, ``gpu_csvm.cpp:272-283`` — we implement the
  mathematically correct refresh the CPU backend uses),
- ``beta = delta_new / delta_old``, ``d = beta * d + r``.

The data-dependent loop is a ``lax.while_loop`` (SURVEY.md §7 hard part (d)):
one compiled program regardless of how many iterations CG takes, no host
round-trips inside the loop — the analog of the reference's per-iteration
host-staged ``device_reduction`` disappears entirely.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp
from jax import lax

from ..constants import RESIDUAL_REFRESH_INTERVAL
from ..ops.kernel_functions import PRECISION


class CGResult(NamedTuple):
    x: jnp.ndarray  # solution on the padded system (padding entries zero)
    iterations: jnp.ndarray  # int32 scalar: CG iterations executed
    delta: jnp.ndarray  # final squared residual norm
    delta0: jnp.ndarray  # initial squared residual norm


class CGState(NamedTuple):
    """Complete resumable CG state (checkpointable between chunks)."""

    k: jnp.ndarray  # int32 iteration counter
    x: jnp.ndarray
    r: jnp.ndarray
    d: jnp.ndarray
    delta: jnp.ndarray
    delta0: jnp.ndarray


class AdaptiveCGResult(NamedTuple):
    """:class:`CGResult` plus the fast-tier iteration count of the adaptive
    two-tier solve (``fast_iterations == iterations`` means the accurate
    tier was never entered)."""

    x: jnp.ndarray
    iterations: jnp.ndarray
    delta: jnp.ndarray
    delta0: jnp.ndarray
    fast_iterations: jnp.ndarray


def _dot(a, b):
    return jnp.dot(a, b, preferred_element_type=a.dtype, precision=PRECISION)


def cg_solve(
    matvec: Callable,
    b: jnp.ndarray,
    mask: jnp.ndarray,
    eps,
    imax,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: jnp.ndarray | None = None,
    dot: Callable = _dot,
) -> CGResult:
    """Solve ``A x = b`` on the padded system.

    ``b`` and ``mask`` are (D,) with zero padding; ``matvec`` must preserve
    zero padding.  ``eps`` and ``imax`` may be traced scalars so tolerance /
    cap changes do not recompile.

    ``minv`` enables preconditioned CG with the diagonal preconditioner
    ``M^-1 = minv`` (zero on padding entries).  The stopping criterion stays
    on the *unpreconditioned* residual ``r.r <= eps^2 * (r0.r0)`` so
    tolerance semantics match the reference's plain CG
    (``gpu_csvm.cpp:293``); a capability extension, not present upstream.

    ``dot`` customizes the inner product — the multi-chip path passes a
    psummed local dot so the SAME loop runs row-sharded over a mesh (this is
    the single CG serving every execution path, the role the reference's
    ``solver_CG`` plays for its five backends, ``gpu_csvm.cpp:186-324``).
    """
    from ..utils.assertions import plssvm_assert

    plssvm_assert(b.shape == mask.shape,
                  "CG system vectors disagree: b {} vs mask {}", b.shape, mask.shape)
    plssvm_assert(minv is None or minv.shape == b.shape,
                  "preconditioner diagonal shape {} != system shape {}",
                  None if minv is None else minv.shape, b.shape)
    state = cg_init(matvec, b, mask, minv, dot)
    state = cg_run(matvec, b, mask, eps, imax, state, refresh_interval, minv, dot)
    return CGResult(x=state.x, iterations=state.k, delta=state.delta, delta0=state.delta0)


def cg_init(matvec: Callable, b: jnp.ndarray, mask: jnp.ndarray,
            minv: jnp.ndarray | None = None, dot: Callable = _dot) -> CGState:
    """Initial CG state: x = 1 on valid entries, r = b - A x
    (``gpu_csvm.cpp:192-223``).  With ``minv``: d0 = M^-1 r0 (PCG)."""
    dtype = b.dtype
    x0 = mask.astype(dtype)
    r0 = b - matvec(x0)
    delta0 = dot(r0, r0)
    d0 = r0 if minv is None else minv * r0
    return CGState(k=jnp.int32(0), x=x0, r=r0, d=d0, delta=delta0, delta0=delta0)


def cg_run(
    matvec: Callable,
    b: jnp.ndarray,
    mask: jnp.ndarray,
    eps,
    imax,
    state: CGState,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: jnp.ndarray | None = None,
    dot: Callable = _dot,
) -> CGState:
    """Continue CG from ``state`` until convergence or ``imax`` total
    iterations.  Pass ``imax = min(state.k + chunk, total)`` to run a
    checkpointable chunk; the iteration counter keeps the 50-step residual
    refresh aligned across resumes.

    With ``minv`` the loop is diagonal-preconditioned CG; ``state.delta``
    always stores the plain residual norm ``r.r`` so stop semantics,
    logging, and checkpoints are identical to the unpreconditioned path.
    """
    dtype = b.dtype
    eps = jnp.asarray(eps, dtype)
    imax = jnp.asarray(imax, jnp.int32)
    target = eps * eps * state.delta0

    def cond(s: CGState):
        return jnp.logical_and(s.k < imax, s.delta > target)

    def body(s: CGState):
        Ad = matvec(s.d)
        # PCG step scalars come from r.z, not r.r; recomputing r.z from the
        # stored r keeps CGState (and checkpoints) identical for both paths
        rz = s.delta if minv is None else dot(s.r, minv * s.r)
        alpha = rz / dot(s.d, Ad)
        x = s.x + alpha * s.d

        def refresh(_):
            return b - matvec(x)

        def update(_):
            return s.r - alpha * Ad

        r_new = lax.cond(
            s.k % refresh_interval == refresh_interval - 1, refresh, update, None
        )
        delta_new = dot(r_new, r_new)
        if minv is None:
            beta = delta_new / s.delta
            d_new = beta * s.d + r_new
        else:
            z_new = minv * r_new
            beta = dot(r_new, z_new) / rz
            d_new = beta * s.d + z_new
        return CGState(k=s.k + 1, x=x, r=r_new, d=d_new, delta=delta_new,
                       delta0=s.delta0)

    return lax.while_loop(cond, body, state)


def _default_patience() -> int:
    """Iterations without a >=10% residual improvement before the adaptive
    solve declares the fast dot tier stagnated.  ``PLSSVM_CG_STAG_PATIENCE``
    overrides (read at trace time — a changed value needs a fresh trace,
    like every precision knob)."""
    import os

    try:
        return int(os.environ.get("PLSSVM_CG_STAG_PATIENCE", STAGNATION_PATIENCE))
    except ValueError:
        return STAGNATION_PATIENCE


STAGNATION_PATIENCE: int = 8


def cg_run_stagnation(
    matvec: Callable,
    b: jnp.ndarray,
    mask: jnp.ndarray,
    eps,
    imax,
    state: CGState,
    *,
    patience: int | None = None,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: jnp.ndarray | None = None,
    dot: Callable = _dot,
) -> CGState:
    """:func:`cg_run` with a stagnation exit: the loop also stops when the
    residual norm has not improved on its best-seen value by at least 10%
    for ``patience`` consecutive iterations — the signature of a matvec
    whose error floor (e.g. bf16 or TF32 products) sits above the
    requested tolerance.  The detector is armed only when the convergence
    target is positive; ``eps = 0`` (pinned-iteration mode, used by the
    benchmarks) runs exactly like :func:`cg_run`.

    The caller distinguishes the exits by inspecting the returned state:
    ``delta <= eps^2 * delta0`` converged, ``k >= imax`` exhausted,
    anything else stagnated.
    """
    if patience is None:
        patience = _default_patience()
    dtype = b.dtype
    eps = jnp.asarray(eps, dtype)
    imax = jnp.asarray(imax, jnp.int32)
    target = eps * eps * state.delta0
    armed = target > 0

    def cond(carry):
        s, best, since = carry
        return jnp.logical_and(
            jnp.logical_and(s.k < imax, s.delta > target),
            jnp.logical_not(jnp.logical_and(armed, since >= patience)),
        )

    def body(carry):
        s, best, since = carry
        Ad = matvec(s.d)
        rz = s.delta if minv is None else dot(s.r, minv * s.r)
        alpha = rz / dot(s.d, Ad)
        x = s.x + alpha * s.d

        def refresh(_):
            return b - matvec(x)

        def update(_):
            return s.r - alpha * Ad

        r_new = lax.cond(
            s.k % refresh_interval == refresh_interval - 1, refresh, update, None
        )
        delta_new = dot(r_new, r_new)
        if minv is None:
            beta = delta_new / s.delta
            d_new = beta * s.d + r_new
        else:
            z_new = minv * r_new
            beta = dot(r_new, z_new) / rz
            d_new = beta * s.d + z_new
        improved = delta_new < 0.9 * best
        best = jnp.minimum(best, delta_new)
        since = jnp.where(improved, 0, since + 1)
        return (
            CGState(k=s.k + 1, x=x, r=r_new, d=d_new, delta=delta_new,
                    delta0=s.delta0),
            best,
            since,
        )

    carry = (state, state.delta, jnp.int32(0))
    state, _best, _since = lax.while_loop(cond, body, carry)
    return state


def cg_solve_adaptive(
    matvec_fast: Callable,
    matvec_acc: Callable,
    b: jnp.ndarray,
    mask: jnp.ndarray,
    eps,
    imax,
    *,
    patience: int | None = None,
    refresh_interval: int = RESIDUAL_REFRESH_INTERVAL,
    minv: jnp.ndarray | None = None,
    dot: Callable = _dot,
) -> AdaptiveCGResult:
    """Two-tier adaptive solve: run CG on the cheap ``matvec_fast`` (1-pass
    reduced-precision products) until it converges, stagnates, or exhausts ``imax``;
    then verify the residual with ``matvec_acc`` (f32-grade 3-pass
    split-bf16) and, if the target is not actually met, continue CG from
    the current iterate on the accurate tier.

    The verification makes the convergence contract independent of the fast
    tier's error floor: a returned ``delta <= eps^2 * delta0`` is always an
    *accurate-tier* residual.  The JAX form of the reference's
    fast-math trade (``OpenCL/detail/utility.cpp:287``) with a safety net
    the reference does not have.

    ``eps = 0`` pins the iteration count on the fast tier (stagnation and
    escalation both disarm — there is no target to reach), preserving the
    fixed-iteration benchmark semantics of :func:`cg_solve`.
    """
    from ..utils.assertions import plssvm_assert

    plssvm_assert(b.shape == mask.shape,
                  "CG system vectors disagree: b {} vs mask {}", b.shape, mask.shape)
    dtype = b.dtype
    eps = jnp.asarray(eps, dtype)
    imax = jnp.asarray(imax, jnp.int32)

    state = cg_init(matvec_fast, b, mask, minv, dot)
    state = cg_run_stagnation(
        matvec_fast, b, mask, eps, imax, state,
        patience=patience, refresh_interval=refresh_interval, minv=minv, dot=dot,
    )
    k_fast = state.k
    target = eps * eps * state.delta0

    # accurate-tier residual at the fast iterate (one matvec — noise next to
    # the solve; with eps = 0 it is skipped and the fast recurrence is kept)
    def verify(s: CGState) -> CGState:
        r = b - matvec_acc(s.x)
        d = r if minv is None else minv * r
        return CGState(k=s.k, x=s.x, r=r, d=d, delta=dot(r, r), delta0=s.delta0)

    armed = target > 0
    state = lax.cond(armed, verify, lambda s: s, state)

    def escalate(s: CGState) -> CGState:
        return cg_run(matvec_acc, b, mask, eps, imax, s,
                      refresh_interval=refresh_interval, minv=minv, dot=dot)

    need = jnp.logical_and(armed,
                           jnp.logical_and(state.delta > target, state.k < imax))
    state = lax.cond(need, escalate, lambda s: s, state)
    return AdaptiveCGResult(x=state.x, iterations=state.k, delta=state.delta,
                            delta0=state.delta0, fast_iterations=k_fast)
