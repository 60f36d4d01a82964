"""The LS-SVM estimator: learn / predict / accuracy / write_model.

JAX equivalent of the algorithm core ``plssvm::csvm<T>``
(``include/plssvm/csvm.hpp:34-278``, ``src/plssvm/csvm.cpp:40-411``) merged
with the device orchestration of ``plssvm::detail::gpu_csvm``
(``src/plssvm/backends/gpu_csvm.cpp:47-412``).  Where the reference splits
``learn()`` into five virtual device hooks (``setup_data_on_device``,
``generate_q``, ``solver_CG``, ``update_w``, ``predict``) so each backend can
re-implement them, here the entire learn step is **one traced XLA program**:
q-vector, QA_cost, operator construction and the full CG loop compile into a
single ``jit`` with no host round-trips (the reference crosses the host
boundary every iteration for its ``device_reduction``,
``gpu_csvm.cpp:366-386``).

Padding: the CG system of size ``dept = n - 1`` is zero-padded to a multiple
of the row block so every block is full — the analog of the reference's
``boundary_size_ = 96`` padding (``gpu_csvm.cpp:130-157``), 128-lane aligned.
"""

from __future__ import annotations

import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import PAD_SIZE, ROW_BLOCK_SIZE
from ..device import check_target, device_memory_bytes
from ..exceptions import PLSSVMError
from ..io.model import write_model_file
from ..ops.kernel_functions import PRECISION, gram_block, kernel_scalar
from ..ops.matvec import build_operator, choose_mode, jacobi_minv as _jacobi_minv
from ..params import Parameter
from ..solver.cg import cg_init, cg_run, cg_solve
from ..types import KernelType


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.jit, static_argnames=("kernel", "degree", "mode", "precond",
                                   "precision_plan"))
def _learn_jit(X_pad, x_last, b_pad, mask, gamma, coef0, cost, eps, imax,
               *, kernel: KernelType, degree: int, mode: str,
               precond: str = "none", precision_plan: tuple | None = None):
    """One traced program: q-vector + QA_cost + operator + full CG solve.

    ``precision_plan = (fast_tier, acc_tier)`` enables the adaptive two-tier CG
    (``ops/matvec.resolve_precision_plan``): the solve starts on the fast tier
    and escalates on stagnation / a failed accurate-tier residual check.
    The 8th output is the fast-tier iteration count (== iterations when no
    escalation happened; == iterations trivially on the fixed path)."""
    dtype = X_pad.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost

    # q_i = k(x_i, x_last)  (q_kernel.cu:16-49); padding rows masked out
    q = gram_block(kernel, X_pad, x_last[None, :], degree, gamma, coef0)[:, 0] * mask
    # QA_cost = k(x_last, x_last) + 1/C  (csvm.cpp:243)
    QA_cost = kernel_scalar(kernel, x_last, x_last, degree, gamma, coef0) + cost_inv

    minv = None
    if precond == "jacobi":
        minv = _jacobi_minv(kernel, X_pad, q, mask, QA_cost, cost_inv,
                            degree, gamma, coef0)

    def make_op(prec):
        return build_operator(
            kernel, X_pad, q, mask, QA_cost, cost_inv,
            degree=degree, gamma=gamma, coef0=coef0, mode=mode,
            precision=prec,
        )

    if precision_plan is None:
        res = cg_solve(make_op(None).matvec, b_pad, mask, eps, imax, minv=minv)
        k_fast = res.iterations
    else:
        from ..ops.matvec import tier_precision
        from ..solver.cg import cg_solve_adaptive

        res = cg_solve_adaptive(
            make_op(tier_precision(precision_plan[0])).matvec,
            make_op(tier_precision(precision_plan[1])).matvec,
            b_pad, mask, eps, imax, minv=minv,
        )
        k_fast = res.fast_iterations

    s = jnp.sum(res.x)
    t = jnp.dot(q, res.x, preferred_element_type=dtype, precision=PRECISION)
    return res.x, s, t, QA_cost, res.iterations, res.delta, res.delta0, k_fast


@partial(jax.jit, static_argnames=("kernel", "degree", "mode", "precond"))
def _cg_setup_jit(X_pad, x_last, b_pad, mask, gamma, coef0, cost,
                  *, kernel: KernelType, degree: int, mode: str,
                  precond: str = "none"):
    """q-vector, QA_cost, and the initial CG state (checkpointed learn)."""
    dtype = X_pad.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost
    q = gram_block(kernel, X_pad, x_last[None, :], degree, gamma, coef0)[:, 0] * mask
    QA_cost = kernel_scalar(kernel, x_last, x_last, degree, gamma, coef0) + cost_inv
    op = build_operator(
        kernel, X_pad, q, mask, QA_cost, cost_inv,
        degree=degree, gamma=gamma, coef0=coef0, mode=mode,
    )
    minv = None
    if precond == "jacobi":
        minv = _jacobi_minv(kernel, X_pad, q, mask, QA_cost, cost_inv,
                            degree, gamma, coef0)
    state = cg_init(op.matvec, b_pad, mask, minv=minv)
    return q, QA_cost, state


@partial(jax.jit, static_argnames=("kernel", "degree", "mode", "precond"))
def _cg_chunk_jit(X_pad, b_pad, mask, q, QA_cost, gamma, coef0, cost, eps, imax_end,
                  state,
                  *, kernel: KernelType, degree: int, mode: str,
                  precond: str = "none"):
    """Run CG until ``imax_end`` total iterations (or convergence)."""
    dtype = X_pad.dtype
    cost_inv = jnp.asarray(1.0, dtype) / cost
    op = build_operator(
        kernel, X_pad, q, mask, QA_cost, cost_inv,
        degree=degree, gamma=gamma, coef0=coef0, mode=mode,
    )
    minv = None
    if precond == "jacobi":
        minv = _jacobi_minv(kernel, X_pad, q, mask, QA_cost, cost_inv,
                            degree, gamma, coef0)
    return cg_run(op.matvec, b_pad, mask, eps, imax_end, state, minv=minv)


@partial(jax.jit, static_argnames=("kernel", "degree"))
def _predict_jit(P, X_sv, alphas, bias, gamma, coef0, *, kernel: KernelType,
                 degree: int):
    """f(p) = sum_i alpha_i k(x_i, p) + bias (``OpenMP/csvm.cpp:223-236``)."""
    K = gram_block(kernel, P, X_sv, degree, gamma, coef0)
    return jnp.dot(K, alphas, preferred_element_type=P.dtype, precision=PRECISION) + bias


@jax.jit
def _w_jit(X_all, alphas):
    """w = sum_i alpha_i x_i — linear predict fast path
    (``predict_kernel.cu:16-27``, ``gpu_csvm.cpp:327-350``)."""
    return jnp.dot(X_all.T, alphas, preferred_element_type=X_all.dtype, precision=PRECISION)


class CSVM:
    """Least-Squares SVM solved with Conjugate Gradients on a JAX device.

    Mirrors the public API of ``plssvm::csvm<T>`` (``csvm.hpp:106-179``):
    ``learn``, ``predict``, ``predict_label``, ``accuracy``, ``write_model``.
    """

    def __init__(self, params: Parameter) -> None:
        # ctor validation (csvm.cpp:41-57)
        if params.data is None:
            raise PLSSVMError("No data points provided!")
        if params.data.num_points == 0:
            raise PLSSVMError("Data set is empty!")
        if params.data.num_features == 0:
            raise PLSSVMError("No features provided for the data points!")
        if params.alphas is not None and len(params.alphas) != params.data.num_points:
            raise PLSSVMError(
                f"Number of weights ({len(params.alphas)}) must match the number of "
                f"data points ({params.data.num_points})!"
            )

        self.params = params
        self.kernel = params.kernel
        self.degree = int(params.degree)
        self.gamma = float(params.gamma)
        self.coef0 = float(params.coef0)
        self.cost = float(params.cost)
        self.epsilon = float(params.epsilon)
        self.print_info = bool(params.print_info)
        self.dtype = self._resolve_dtype(params.dtype)
        check_target(params.target)

        self.data = params.data  # ParsedData (dense + CSR)
        self.values = params.values  # labels (+1/-1) or None
        self.alphas = None if params.alphas is None else np.asarray(params.alphas, np.float64)
        self.bias_ = -float(params.rho)  # csvm.cpp:42
        self.QA_cost_ = 0.0
        self.w_: np.ndarray | None = None
        self.last_cg_info: dict = {}

        self.num_data_points = self.data.num_points
        self.num_features = self.data.num_features

        # cached device copy of the full data matrix (predict / w path)
        self._X_all_dev = None

    def _resolve_dtype(self, dtype):
        """float64 needs JAX x64 mode; without it, solve in float32
        instead of letting jnp truncate noisily."""
        dtype = jnp.dtype(dtype)
        if dtype == jnp.dtype(np.float64) and not jax.config.jax_enable_x64:
            if self.print_info:
                print("float64 requested but JAX x64 mode is disabled; solving in float32.")
            return jnp.dtype(np.float32)
        return dtype

    # ------------------------------------------------------------------ learn

    def learn(self) -> None:
        """Train: assemble the reduced system and solve with CG
        (``csvm.cpp:207-267``)."""
        if self.values is None:
            raise PLSSVMError(
                "No labels given for training! Maybe the data is only usable for prediction?"
            )
        if self.num_data_points != len(self.values):
            raise PLSSVMError(
                f"Number of labels ({len(self.values)}) must match the number of "
                f"data points ({self.num_data_points})!"
            )

        y = np.asarray(self.values, np.float64)
        n, f = self.data.csr.shape
        dept = n - 1

        if dept == 0:
            # degenerate single-point system: alpha = [0], bias = y[0]
            self.alphas = np.zeros(1)
            self.bias_ = float(y[0])
            self.w_ = None
            return

        start = time.perf_counter()
        imax = self.params.max_iter if self.params.max_iter is not None else f
        # don't spread a tiny system over chips (the analog of the reference's
        # devices_ = min(device_count, num_features), CUDA/csvm.cu:52 — here
        # the scaling axis is rows, so the cap is rows-per-shard >= PAD_SIZE)
        ndev = min(self._num_devices(), max(1, dept // PAD_SIZE))

        ndev_req = self._num_devices()
        if (not self._use_sparse() and ndev_req > 1
                and self._shard_axis(dept, f, ndev_req) == "features"):
            # wide-dense regime (f/p > D): the reference's own multi-GPU
            # decomposition (feature_ranges_, gpu_csvm.cpp:130-157),
            # generalized to all three kernels — O(D) comms for linear,
            # O(D^2) blockwise-psum Gram assembly for poly/rbf, vs the row
            # ring's O(D*f) — product-reachable with zero new flags;
            # PLSSVM_SHARD_AXIS=rows/features overrides
            mode, out = self._learn_dense_feature_sharded(
                dept, f, y, imax, ndev_req)
        elif self._use_sparse() and ndev > 1:
            mode, out = self._learn_sparse_sharded(dept, f, y, imax, ndev)
        elif self._use_sparse():
            D = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
            b_pad, mask = self._padded_vectors(D, dept, y)
            mode, out = self._learn_sparse(D, dept, f, b_pad, mask, imax)
        elif ndev > 1:
            # transparent multi-chip learn — the analog of the reference
            # using every visible GPU (gpu_csvm.cpp:130-157) with XLA
            # collectives instead of its host-staged device_reduction
            mode, out = self._learn_dense_sharded(dept, f, y, imax, ndev)
        else:
            D = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
            b_pad, mask = self._padded_vectors(D, dept, y)
            mode, out = self._learn_dense(D, dept, f, b_pad, mask, imax)
        x, s, t, QA_cost, iters, delta, delta0, *extra = out
        x = np.asarray(x, np.float64)
        D = len(x)  # padded system size (strategy-dependent alignment)
        x = x[:dept]
        s_np = float(s)
        self.QA_cost_ = float(QA_cost)

        # bias = y_last + QA_cost * sum(x) - q.x ; alpha_last = -sum(x)
        # (csvm.cpp:257-258)
        self.bias_ = float(y[-1]) + self.QA_cost_ * s_np - float(t)
        self.alphas = np.concatenate([x, [-s_np]])
        self.w_ = None
        self.last_cg_info = {
            "iterations": int(iters),
            "delta": float(delta),
            "delta0": float(delta0),
            "mode": mode,
            "dept": dept,
            "padded": D,
        }
        if extra:
            # adaptive two-tier CG: iterations spent on the fast dot tier
            # before (possible) escalation to the accurate tier
            self.last_cg_info["fast_iterations"] = int(extra[0])
            self.last_cg_info["escalated"] = int(iters) > int(extra[0])

        if self.print_info:
            elapsed = (time.perf_counter() - start) * 1000.0
            print(
                f"Finished after {int(iters)} iterations with a residuum of "
                f"{float(delta)} (target: {self.epsilon**2 * float(delta0)})."
            )
            if self.last_cg_info.get("escalated"):
                kf = self.last_cg_info["fast_iterations"]
                print(
                    f"Adaptive precision: {kf} iterations on the fast dot "
                    f"tier, {int(iters) - kf} after escalating to the "
                    f"accurate tier."
                )
            print(f"Solved minimization problem (r = b - Ax) using CG in {elapsed:.0f}ms.")

    # ------------------------------------------------------- learn strategies

    def _use_sparse(self) -> bool:
        """Keep the CSR representation when the data is sparse enough
        (capability extension over the always-densifying reference,
        ``parameter.hpp:51-75``)."""
        return self.data.density <= float(self.params.sparse_threshold)

    def _num_devices(self) -> int:
        """Devices to span, mirroring the reference's transparent use of
        every visible GPU (``CUDA/csvm.cu:52``).  ``Parameter.devices`` or
        ``PLSSVM_DEVICES`` pins a count; capped at what's visible."""
        try:
            if self.params.devices is not None:
                n = int(self.params.devices)
            else:
                env = os.environ.get("PLSSVM_DEVICES", "")
                n = int(env) if env else jax.device_count()
        except (TypeError, ValueError) as exc:
            raise PLSSVMError(
                f"Invalid device count (Parameter.devices / PLSSVM_DEVICES): "
                f"{exc}"
            ) from None
        return max(1, min(n, jax.device_count()))

    def _padded_vectors(self, D, dept, y):
        b_pad = np.zeros(D, dtype=self.dtype)
        b_pad[:dept] = y[:dept] - y[-1]  # b = y[:-1] - y[-1] (csvm.cpp:236-240)
        mask = np.zeros(D, dtype=self.dtype)
        mask[:dept] = 1.0
        return b_pad, mask

    def _scalar_args(self):
        return (
            jnp.asarray(self.gamma, self.dtype),
            jnp.asarray(self.coef0, self.dtype),
            jnp.asarray(self.cost, self.dtype),
        )

    def _mesh(self, ndev):
        from ..parallel.mesh import make_mesh

        if getattr(self, "_mesh_cache", None) is None or self._mesh_cache.devices.size != ndev:
            self._mesh_cache = make_mesh(ndev)
        return self._mesh_cache

    def _shard_axis(self, dept, f, ndev) -> str:
        """Multi-chip partition axis for dense data.  ``auto`` row-shards
        (better for tall data: all kernels, nnz-balanced) unless the data
        is so wide that each chip's feature slice still exceeds the system
        size (``f/ndev > D``) — then the feature split (the reference's own
        decomposition) wins on comms volume.  ``PLSSVM_SHARD_AXIS`` forces
        ``rows``/``features``.  Both axes support the full feature set
        (chunked CG for checkpoint/verbose included)."""
        axis = os.environ.get("PLSSVM_SHARD_AXIS", "auto")
        if axis not in ("auto", "rows", "features"):
            raise PLSSVMError(
                f"Invalid PLSSVM_SHARD_AXIS '{axis}' "
                "(expected auto, rows, or features)")
        if axis != "auto":
            return axis
        return "features" if f // ndev > dept else "rows"

    def _learn_dense_feature_sharded(self, dept, f, y, imax, ndev):
        """Feature-axis-sharded multi-chip learn (wide-dense regime) —
        ``parallel/sharded.py make_feature_sharded_learn``, the
        generalization of the reference's ``feature_ranges_`` split."""
        from ..constants import ROW_BLOCK_SIZE as _RBS
        from ..parallel.sharded import (make_feature_sharded_learn,
                                        make_feature_sharded_learn_fns,
                                        shard_system_feature)

        D = _round_up(dept, max(PAD_SIZE, _RBS))
        b_pad, mask = self._padded_vectors(D, dept, y)
        fp = _round_up(f, ndev)
        X = self.data.dense
        X_pad = np.zeros((D, fp), dtype=self.dtype)
        X_pad[:dept, :f] = X[:dept]
        x_last = np.zeros(fp, dtype=self.dtype)
        x_last[:f] = X[-1]
        mesh = self._mesh(ndev)
        Xs, xl, bs, ms = shard_system_feature(mesh, X_pad, x_last, b_pad, mask)
        precond = str(self.params.precond)
        mode_name = f"sharded_feature[{ndev}]"

        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            setup_jit, chunk_jit = make_feature_sharded_learn_fns(
                mesh, self.kernel, self.degree, precond=precond)
            scalars = self._scalar_args()
            eps = jnp.asarray(self.epsilon, self.dtype)

            def setup():
                return setup_jit(Xs, xl, bs, ms, *scalars)

            def chunk(q, QA_cost, imax_end, state):
                return chunk_jit(Xs, bs, ms, xl, *scalars, eps,
                                 jnp.asarray(imax_end, jnp.int32), state)

            q, QA_cost, state = self._drive_chunked_cg(setup, chunk, imax, dept)
            x_np = np.asarray(state.x, np.float64)
            s = x_np.sum()
            t = np.asarray(q, np.float64) @ x_np
            return mode_name, (state.x, s, t, QA_cost, state.k, state.delta,
                               state.delta0)

        learn = make_feature_sharded_learn(
            mesh, self.kernel, self.degree, precond=precond)
        out = learn(
            Xs, xl, bs, ms, *self._scalar_args(),
            jnp.asarray(self.epsilon, self.dtype),
            jnp.asarray(imax, jnp.int32),
        )
        return mode_name, out

    def _learn_dense_sharded(self, dept, f, y, imax, ndev):
        """Row-sharded multi-chip learn (``parallel/sharded.py``): zero new
        flags, same outputs — the product-surface twin of the reference's
        multi-device ``learn()`` (``gpu_csvm.cpp:130-157``)."""
        from ..ops.matvec import choose_sharded_mode, resolve_precision_plan
        from ..parallel.sharded import (make_sharded_learn,
                                        make_sharded_learn_fns, shard_system)

        # every shard PAD_SIZE-aligned
        D = _round_up(dept, PAD_SIZE * ndev)
        b_pad, mask = self._padded_vectors(D, dept, y)
        X = self.data.dense
        X_pad = np.zeros((D, f), dtype=self.dtype)
        X_pad[:dept] = X[:dept]
        x_last = jnp.asarray(X[-1].astype(self.dtype))
        mode = choose_sharded_mode(self.kernel, dept, self.dtype, ndev)
        mesh = self._mesh(ndev)
        Xs, bs, ms = shard_system(mesh, X_pad, b_pad, mask)
        precond = str(self.params.precond)
        mode_name = f"sharded_{mode}[{ndev}]"

        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            setup_jit, chunk_jit = make_sharded_learn_fns(
                mesh, self.kernel, self.degree, mode, precond=precond)
            scalars = self._scalar_args()
            eps = jnp.asarray(self.epsilon, self.dtype)

            def setup():
                return setup_jit(Xs, x_last, bs, ms, *scalars)

            def chunk(q, QA_cost, imax_end, state):
                return chunk_jit(Xs, bs, ms, x_last, *scalars, eps,
                                 jnp.asarray(imax_end, jnp.int32), state)

            q, QA_cost, state = self._drive_chunked_cg(setup, chunk, imax, dept)
            x_np = np.asarray(state.x, np.float64)
            s = x_np.sum()
            t = np.asarray(q, np.float64) @ x_np
            return mode_name, (state.x, s, t, QA_cost, state.k, state.delta,
                               state.delta0)

        learn = make_sharded_learn(mesh, self.kernel, self.degree, mode,
                                   precond=precond,
                                   precision_plan=resolve_precision_plan(mode, self.dtype))
        out = learn(
            Xs, x_last, bs, ms, *self._scalar_args(),
            jnp.asarray(self.epsilon, self.dtype), jnp.asarray(imax, jnp.int32),
        )
        return mode_name, out

    def _drive_chunked_cg(self, setup, chunk, imax, dept):
        """Host-side chunked-CG driver shared by the dense and sharded learn
        paths: periodic checkpoints + optional per-iteration residual output
        (``gpu_csvm.cpp:245-247``).  ``setup() -> (q, QA_cost, state)``;
        ``chunk(q, QA_cost, imax_end, state) -> state``."""
        from ..solver.checkpoint import load_cg_checkpoint, save_cg_checkpoint

        path = self.params.checkpoint_path
        interval = max(1, int(self.params.checkpoint_interval))
        if self.params.verbose_cg:
            interval = 1  # per-iteration residual output (gpu_csvm.cpp:245-247)

        loaded = load_cg_checkpoint(path) if path is not None else None
        if loaded is not None:
            state, q, QA_cost, meta = loaded
            if int(meta.get("dept", -1)) != dept or int(meta.get("kernel", -1)) != int(self.kernel):
                raise PLSSVMError(
                    f"Checkpoint '{path}' does not match this training problem!"
                )
            if self.print_info:
                print(f"Resumed CG from checkpoint '{path}' at iteration {int(state.k)}.")
        else:
            q, QA_cost, state = setup()

        target = float(self.epsilon) ** 2 * float(state.delta0)
        meta = {"dept": dept, "kernel": int(self.kernel)}
        while int(state.k) < imax and float(state.delta) > target:
            if self.params.verbose_cg and self.print_info:
                # reference per-iteration line (gpu_csvm.cpp:245-247)
                print(
                    f"Start Iteration {int(state.k) + 1} (max: {imax}) with current "
                    f"residuum {float(state.delta)} (target: {target}). "
                )
            end = min(int(state.k) + interval, imax)
            state = chunk(q, QA_cost, end, state)
            if path is not None:
                save_cg_checkpoint(path, state, q, QA_cost, meta)
        return q, QA_cost, state

    def _learn_dense(self, D, dept, f, b_pad, mask, imax):
        from ..ops.matvec import resolve_precision_plan

        X = self.data.dense
        X_pad = np.zeros((D, f), dtype=self.dtype)
        X_pad[:dept] = X[:dept]
        x_last = X[-1].astype(self.dtype)
        mode = choose_mode(self.kernel, dept, self.dtype)
        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            # the chunked driver runs the fixed tier (checkpoint states stay
            # tier-independent; the adaptive solve is a single-jit property)
            return self._learn_dense_checkpointed(
                X_pad, x_last, b_pad, mask, imax, mode, dept
            )
        out = _learn_jit(
            jnp.asarray(X_pad), jnp.asarray(x_last), jnp.asarray(b_pad), jnp.asarray(mask),
            jnp.asarray(self.gamma, self.dtype), jnp.asarray(self.coef0, self.dtype),
            jnp.asarray(self.cost, self.dtype), jnp.asarray(self.epsilon, self.dtype),
            jnp.asarray(imax, jnp.int32),
            kernel=self.kernel, degree=self.degree, mode=mode,
            precond=str(self.params.precond),
            precision_plan=resolve_precision_plan(mode, self.dtype),
        )
        return mode, out

    def _learn_dense_checkpointed(self, X_pad, x_last, b_pad, mask, imax, mode, dept):
        """Dense learn with periodic CG-state checkpoints (resume-capable).

        Extension over the reference, whose only checkpoint is the final
        model file (SURVEY.md §5).
        """
        Xd, bd, md = jnp.asarray(X_pad), jnp.asarray(b_pad), jnp.asarray(mask)
        scalars = self._scalar_args()
        eps = jnp.asarray(self.epsilon, self.dtype)
        precond = str(self.params.precond)

        def setup():
            return _cg_setup_jit(
                Xd, jnp.asarray(x_last), bd, md, *scalars,
                kernel=self.kernel, degree=self.degree, mode=mode,
                precond=precond,
            )

        def chunk(q, QA_cost, imax_end, state):
            return _cg_chunk_jit(
                Xd, bd, md, q, QA_cost, *scalars, eps,
                jnp.asarray(imax_end, jnp.int32), state,
                kernel=self.kernel, degree=self.degree, mode=mode,
                precond=precond,
            )

        q, QA_cost, state = self._drive_chunked_cg(setup, chunk, imax, dept)
        dtype = self.dtype
        s = jnp.sum(state.x)
        t = jnp.dot(jnp.asarray(q, dtype), state.x,
                    preferred_element_type=dtype, precision=PRECISION)
        return mode, (state.x, s, t, QA_cost, state.k, state.delta, state.delta0)

    def _learn_sparse_sharded(self, dept, f, y, imax, ndev):
        """Multi-chip learn on CSR-retained data (transparent, zero flags).

        - linear: row-sharded ELL+COO CG — nnz-proportional work per chip,
          O(f) comms per iteration (`parallel/sharded.py`
          `make_sharded_sparse_linear_learn`).  Beyond the reference, whose
          multi-GPU path requires dense data (``gpu_csvm.cpp:130-157``).
        - poly/rbf: when dense X fits the memory budget, densify and ride
          the sharded dense path (ring implicit / sharded cached);
          beyond the budget, ring-sharded streaming walks the ELL+COO
          shards around the mesh per CG iteration at O(n*L/p) memory per
          chip (a forced PLSSVM_SPARSE_MODE pins the single-chip tier).
        """
        if self.kernel == KernelType.linear:
            self._reject_chunk_flags_on_sparse()
            from ..parallel.sharded import make_sharded_sparse_linear_learn

            mesh, args, x_last = self._sparse_sharded_system(dept, y, ndev)
            learn = make_sharded_sparse_linear_learn(
                mesh, precond=str(self.params.precond))
            out = learn(
                *args[:5], jnp.asarray(x_last), *args[5:],
                jnp.asarray(self.cost, self.dtype),
                jnp.asarray(self.epsilon, self.dtype),
                jnp.asarray(imax, jnp.int32),
            )
            return f"sharded_sparse_linear[{ndev}]", out

        from ..ops.matvec import _k_cache_budget_bytes

        itemsize = jnp.dtype(self.dtype).itemsize
        dept_pad = _round_up(dept, PAD_SIZE * ndev)
        forced_tier = os.environ.get("PLSSVM_SPARSE_MODE", "auto") != "auto"
        if not forced_tier and (
            dept_pad * f * itemsize <= _k_cache_budget_bytes() * ndev
            # per-device working set: the dense slab + its transients
            and 5 * dept_pad * f * itemsize // (2 * ndev)
            <= self._device_memory_bytes()
        ):
            # densify once (budget-gated) and use every chip via the dense
            # sharded path; self.data.dense densifies the CSR on demand
            return self._learn_dense_sharded(dept, f, y, imax, ndev)
        if not forced_tier and (
            dept_pad * dept_pad * itemsize <= _k_cache_budget_bytes()
        ):
            # wide data (f >> n): dense X is out of budget but the (D, D)
            # Gram fits — the one-time Gram assembly + cached GEMV CG beats
            # recomputing kernel blocks every iteration by orders of
            # magnitude; the sparse tier ladder picks it (host SpGEMM for
            # extreme widths)
            D = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
            b_pad, mask = self._padded_vectors(D, dept, y)
            return self._learn_sparse(D, dept, f, b_pad, mask, imax)
        # beyond-budget poly/rbf: ring-sharded streaming — each chip holds
        # only its ELL+COO shard and the shards walk the ring per CG
        # iteration (the HBM-exceeding sparse regime on a mesh,
        # BASELINE.json config 5).  An explicitly forced sparse tier pins
        # the single-chip path instead.
        if forced_tier:
            D = _round_up(dept, max(PAD_SIZE, ROW_BLOCK_SIZE))
            b_pad, mask = self._padded_vectors(D, dept, y)
            return self._learn_sparse(D, dept, f, b_pad, mask, imax)
        self._reject_chunk_flags_on_sparse()
        csr = self.data.csr
        scalars = (
            jnp.asarray(self.gamma, self.dtype),
            jnp.asarray(self.coef0, self.dtype),
            jnp.asarray(self.cost, self.dtype),
            jnp.asarray(self.epsilon, self.dtype),
            jnp.asarray(imax, jnp.int32),
        )
        D = _round_up(dept, PAD_SIZE * ndev)
        plan = self._plan_sparse_panel(csr, dept, D, ndev=ndev)
        if plan is not None:
            th, sweep = plan
            # moderate density: tiled slabs ring the mesh; per hop both
            # sides densify scatter-free into budget-sized panels and run
            # the same Gram-matvec as the dense ring hop
            from ..ops.sparse import stream_panel_rows
            from ..parallel.sharded import (make_sharded_sparse_panel_learn,
                                            shard_sparse_tiled_system)

            b_pad, mask = self._padded_vectors(D, dept, y)
            x_last = np.asarray(csr[-1].todense()).ravel().astype(self.dtype)
            mesh = self._mesh(ndev)
            panel_rows = stream_panel_rows(
                D // ndev, th.tell.padded_features, itemsize,
                _k_cache_budget_bytes())
            learn = make_sharded_sparse_panel_learn(
                mesh, self.kernel, self.degree, ntiles=th.tell.ntiles,
                Lt=th.tell.Lt, panel_rows=panel_rows, sweep=sweep,
                precond=str(self.params.precond))
            tv, tc, hv, hr, bs, ms = shard_sparse_tiled_system(
                mesh, th, b_pad, mask)
            out = learn(tv, tc, hv, hr, jnp.asarray(x_last), bs, ms, *scalars)
            return f"sharded_sparse_implicit[{ndev}]", out

        from ..parallel.sharded import make_sharded_sparse_streaming_learn

        mesh, args, x_last = self._sparse_sharded_system(dept, y, ndev)
        learn = make_sharded_sparse_streaming_learn(
            mesh, self.kernel, self.degree, precond=str(self.params.precond))
        out = learn(*args[:5], jnp.asarray(x_last), *args[5:], *scalars)
        return f"sharded_sparse_implicit[{ndev}]", out

    def _plan_sparse_panel(self, csr, dept, D, ndev: int = 1):
        """``(TiledHybrid, sweep)`` when the streaming ``panel`` strategy
        applies at this density/packing, else ``None`` — the ONE selection
        policy shared by the single-device and ring streaming learns
        (density pre-check, skew-robust packing, the half-dense guard, the
        sweep-schedule choice with its memory envelope).

        ``ndev > 1`` plans for the ring-sharded learn, where each chip
        holds and densifies only a ``1/ndev`` slab — the guards scale to
        per-shard bytes (an unscaled guard would refuse the GEMM-rate
        ring ~ndev times too early)."""
        from ..ops.matvec import _k_cache_budget_bytes
        from ..ops.sparse import (TiledHybrid, panel_sweep_strategy,
                                  stream_panel_rows,
                                  streaming_stream_strategy)

        f = csr.shape[1]
        L_est = max(1, -(-int(csr.indptr[dept]) // max(1, dept)))
        if streaming_stream_strategy(L_est, f) != "panel":
            return None
        th = TiledHybrid.from_csr(csr[:dept], dtype=self.dtype, pad_rows=D)
        itemsize = jnp.dtype(self.dtype).itemsize
        dense_bytes = D * th.tell.padded_features * itemsize
        packed_bytes = (th.tell.vals.size * (itemsize + 4)  # value + int32 col
                        + th.heavy.size * itemsize)
        # memory guard 1: a packing at >= half the padded-dense size means
        # the data is not actually sparse enough (or is pathologically
        # skewed beyond the heavy-row spill) — the nnz-proportional gather
        # arm is the memory-safe choice
        if 2 * packed_bytes > dense_bytes:
            return None
        physical = self._device_memory_bytes()
        rows = D // ndev
        nP = -(-rows // stream_panel_rows(rows, th.tell.padded_features,
                                          itemsize, _k_cache_budget_bytes()))
        if ndev > 1:
            # ring-sharded: per chip, the resident slab is packed/ndev and
            # the hop sweep keeps the hoisted local panels (dense/ndev) +
            # in-flight transients live — the ~4x-dense envelope of the
            # unrolled sweep (not re-measured on the GPU, ROADMAP C4),
            # applied to the PER-SHARD slab.  A hop multiplies every local
            # panel with every in-flight one: nP^2 pair products
            if 4 * dense_bytes // ndev > physical:
                return None
            sweep = panel_sweep_strategy(nP * nP)
        else:
            # single chip: the fast unrolled sweep when its ~4x-dense
            # transient envelope fits physical memory and its pair count
            # compiles in reasonable time, else the bounded-liveness
            # windowed sweep whose transient follows min(budget,
            # physical/3) instead of the dense size — this is what serves
            # the physically-beyond-memory regime (BASELINE config 3).
            # Only the RESIDENT packing + that bounded window must then fit.
            sweep = panel_sweep_strategy(nP * (nP + 1) // 2, dense_bytes,
                                         physical)
            if sweep == "unrolled":
                if 4 * dense_bytes > physical:
                    return None  # forced-unrolled beyond its envelope
            else:
                eff_budget = min(_k_cache_budget_bytes(), physical // 3)
                if packed_bytes + eff_budget > (9 * physical) // 10:
                    return None
        return th, sweep

    @staticmethod
    def _device_memory_bytes() -> int:
        """Physical per-device memory (``device.device_memory_bytes``)."""
        return device_memory_bytes()

    def _reject_chunk_flags_on_sparse(self):
        """Sparse learns cannot chunk CG for checkpoints / per-iteration
        output — refuse loudly (one message, every sparse path)."""
        if self.params.checkpoint_path is not None or self.params.verbose_cg:
            raise PLSSVMError(
                "--checkpoint/--verbose_cg are not supported on the sparse "
                "learn path; set sparse_threshold=0 to force the dense path"
            )

    def _sparse_sharded_system(self, dept, y, ndev):
        """Shared setup for the sharded sparse learns: pad, pack, shard."""
        from ..ops.sparse import HybridSparse
        from ..parallel.sharded import shard_sparse_system

        csr = self.data.csr
        D = _round_up(dept, PAD_SIZE * ndev)
        b_pad, mask = self._padded_vectors(D, dept, y)
        h = HybridSparse.from_csr(csr[:dept], dtype=self.dtype, pad_rows=D)
        x_last = np.asarray(csr[-1].todense()).ravel().astype(self.dtype)
        mesh = self._mesh(ndev)
        return mesh, shard_sparse_system(mesh, h, b_pad, mask), x_last

    def _learn_sparse(self, D, dept, f, b_pad, mask, imax):
        from ..ops.sparse import host_gram_from_csr
        from .sparse_learn import learn_from_gram_jit, learn_sparse_linear_jit

        # loud instead of silent (the reference has one solver_CG with one
        # feature set everywhere; here these two flags are dense-path only)
        self._reject_chunk_flags_on_sparse()
        precond = str(self.params.precond)
        csr = self.data.csr
        common = (
            jnp.asarray(self.cost, self.dtype), jnp.asarray(self.epsilon, self.dtype),
            jnp.asarray(imax, jnp.int32),
        )
        if self.kernel == KernelType.linear:
            from ..ops.sparse import HybridSparse

            h = HybridSparse.from_csr(csr[:dept], dtype=self.dtype, pad_rows=D)
            x_last = np.asarray(csr[-1].todense()).ravel().astype(self.dtype)
            out = learn_sparse_linear_jit(
                h.ell.values, h.ell.cols, h.coo_rows, h.coo_cols, h.coo_vals,
                jnp.asarray(x_last),
                jnp.asarray(b_pad), jnp.asarray(mask), *common, f=f,
                precond=precond,
            )
            return "sparse_linear", out

        # poly/rbf sparse tiers, fastest applicable wins (memory-guarded):
        #   1. 'gram'    — (D, D) Gram assembled once, cached GEMV CG
        #                  (~75% of HBM roofline); needs D^2 in the K budget.
        #   2. 'dense'   — densify X only (D x f << D^2 when f << D) and run
        #                  the implicit matvec; needs D*f in the budget.
        #                  This is the big middle regime (many rows,
        #                  moderate features) where the reference's
        #                  always-densify strategy also lives.
        #   3. 'implicit'— streaming CG from the ELL+COO packing at O(n*L)
        #                  memory: kernel blocks recomputed every iteration —
        #                  the only option when even dense X exceeds HBM
        #                  (the north star regime, BASELINE.json config 3).
        # PLSSVM_SPARSE_MODE forces 'gram' / 'dense' / 'implicit'.
        from ..ops.matvec import _k_cache_budget_bytes

        itemsize = jnp.dtype(self.dtype).itemsize
        sparse_mode = os.environ.get("PLSSVM_SPARSE_MODE", "auto")
        physical = self._device_memory_bytes()
        # budget AND physical-working-set guards: the cached tier keeps K
        # (+ its assembly transient) resident, the dense tier keeps X + its
        # transients (~2x dense: an 8.6 GB dense X once ran a 16 GB device
        # out of memory through this route before the physical term)
        gram_fits = (D * D * itemsize <= _k_cache_budget_bytes()
                     and 2 * D * D * itemsize <= physical)
        dense_x_fits = (D * f * itemsize <= _k_cache_budget_bytes()
                        and 5 * D * f * itemsize // 2 <= physical)
        if sparse_mode == "dense" or (
            sparse_mode == "auto" and not gram_fits and dense_x_fits
        ):
            # f64 note: cached (the exact-f64 preference of choose_mode) is
            # unaffordable here by construction; build_operator routes f64
            # implicit to the blocked XLA path (native f64 GEMMs)
            from ..ops.matvec import resolve_precision_plan

            X_pad = np.zeros((D, f), dtype=self.dtype)
            X_pad[:dept] = csr[:dept].toarray()
            x_last = np.asarray(csr[-1].todense()).ravel().astype(self.dtype)
            out = _learn_jit(
                jnp.asarray(X_pad), jnp.asarray(x_last), jnp.asarray(b_pad),
                jnp.asarray(mask), jnp.asarray(self.gamma, self.dtype),
                jnp.asarray(self.coef0, self.dtype), *common,
                kernel=self.kernel, degree=self.degree, mode="implicit",
                precond=precond,
                precision_plan=resolve_precision_plan("implicit", self.dtype),
            )
            return "sparse_dense_implicit", out
        if sparse_mode == "implicit" or (sparse_mode != "gram" and not gram_fits):
            from ..ops.sparse import HybridSparse, stream_panel_rows
            from .sparse_learn import (learn_sparse_implicit_jit,
                                       learn_sparse_panel_jit)

            x_last = np.asarray(csr[-1].todense()).ravel().astype(self.dtype)
            plan = self._plan_sparse_panel(csr, dept, D)
            if plan is not None:
                th, sweep = plan
                # moderate density: transient scatter-free densified panels,
                # one GEMM + kernel function per panel pair
                # (O(n·tiles·Lt + h·f) resident memory)
                budget = _k_cache_budget_bytes()
                if sweep == "windowed":
                    # the windowed transient follows the budget; cap it so
                    # panels + resident packing stay inside physical memory
                    budget = min(budget, self._device_memory_bytes() // 3)
                panel_rows = stream_panel_rows(
                    D, th.tell.padded_features, itemsize, budget)
                # heavy-row O(n)-vector contributions, host-precomputed
                hs = np.zeros(D, dtype=self.dtype)
                hg = np.zeros(D, dtype=self.dtype)
                if len(th.heavy_idx):
                    hrows = csr[th.heavy_idx]
                    hs[th.heavy_idx] = np.asarray(
                        hrows.multiply(hrows).sum(axis=1)).ravel()
                    hg[th.heavy_idx] = np.asarray(
                        (hrows @ csr[-1].T).todense()).ravel()
                from ..ops.matvec import resolve_precision_plan

                out = learn_sparse_panel_jit(
                    th.tell.vals, th.tell.lcols, jnp.asarray(x_last),
                    jnp.asarray(b_pad), jnp.asarray(mask),
                    jnp.asarray(self.gamma, self.dtype),
                    jnp.asarray(self.coef0, self.dtype), *common,
                    kernel=self.kernel, degree=self.degree,
                    ntiles=th.tell.ntiles, Lt=th.tell.Lt,
                    panel_rows=panel_rows, precond=precond,
                    heavy=th.heavy,
                    heavy_rows=tuple(int(r) for r in th.heavy_idx),
                    heavy_sq_vec=jnp.asarray(hs), heavy_g_vec=jnp.asarray(hg),
                    precision_plan=resolve_precision_plan("implicit", self.dtype),
                    sweep=sweep,
                )
                return "sparse_implicit", out

            h = HybridSparse.from_csr(csr[:dept], dtype=self.dtype, pad_rows=D)
            out = learn_sparse_implicit_jit(
                h.ell.values, h.ell.cols, h.coo_rows, h.coo_cols, h.coo_vals,
                jnp.asarray(x_last), jnp.asarray(b_pad), jnp.asarray(mask),
                jnp.asarray(self.gamma, self.dtype),
                jnp.asarray(self.coef0, self.dtype), *common,
                kernel=self.kernel, degree=self.degree, f=f, precond=precond,
            )
            return "sparse_implicit", out

        # Gram path: host densify (transient, budget-gated) + one GEMM.
        # Host densify instead of a device scatter (whether a device
        # scatter-densify is faster on the GPU is open, ROADMAP A3).  Host
        # sparse BLAS handles extremely wide data (news20-scale).
        from ..ops.kernel_functions import PRECISION as _PREC
        from ..ops.sparse import device_gram_max_features

        if f <= device_gram_max_features() and dense_x_fits:
            X_pad = np.zeros((D, f), dtype=self.dtype)
            X_pad[:dept] = csr[:dept].toarray()
            Xd = jnp.asarray(X_pad)
            G_dev = jnp.dot(Xd, Xd.T, preferred_element_type=Xd.dtype,
                            precision=_PREC)
            sq_dev = jnp.sum(Xd * Xd, axis=1)
        else:
            G = host_gram_from_csr(csr, dept)
            G_pad = np.zeros((D, D), dtype=self.dtype)
            G_pad[:dept, :dept] = G
            sq = np.zeros(D, dtype=self.dtype)
            sq[:dept] = np.diag(G)
            G_dev = jnp.asarray(G_pad)
            sq_dev = jnp.asarray(sq)
        q_lin = np.zeros(D, dtype=self.dtype)
        q_lin[:dept] = np.asarray((csr[:dept] @ csr[-1].T).todense()).ravel()
        qa_lin = float((csr[-1] @ csr[-1].T).toarray()[0, 0])
        out = learn_from_gram_jit(
            G_dev, sq_dev, jnp.asarray(q_lin),
            jnp.asarray(qa_lin, self.dtype), jnp.asarray(b_pad), jnp.asarray(mask),
            jnp.asarray(self.gamma, self.dtype), jnp.asarray(self.coef0, self.dtype),
            *common, kernel=self.kernel, degree=self.degree, precond=precond,
        )
        return "sparse_gram", out

    # ---------------------------------------------------------------- predict

    def _X_all_device(self):
        if self._X_all_dev is None:
            self._X_all_dev = jnp.asarray(self.data.dense.astype(self.dtype))
        return self._X_all_dev

    def _padded_sv(self, ndev):
        """Support vectors + alphas zero-padded so the SV axis splits evenly
        over ``ndev`` chips (padding rows carry zero alphas — harmless)."""
        n, f = self.num_data_points, self.num_features
        Np = _round_up(n, ndev * 8)
        cache = getattr(self, "_padded_sv_cache", None)
        if cache is None or cache[0] != Np:
            X_sv = np.zeros((Np, f), dtype=self.dtype)
            X_sv[:n] = self.data.dense
            cache = (Np, jnp.asarray(X_sv))
            self._padded_sv_cache = cache
        a_sv = np.zeros(Np, dtype=self.dtype)
        a_sv[:n] = self.alphas
        return cache[1], jnp.asarray(a_sv)

    def _check_points(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points, np.float64)
        if points.ndim == 1:
            points = points[None, :]
        if points.shape[1] != self.num_features:
            raise PLSSVMError(
                f"Number of features per data point ({self.num_features}) must match "
                f"the number of features per predict point ({points.shape[1]})!"
            )
        return points

    def predict(self, points) -> np.ndarray:
        """Raw decision values (``gpu_csvm.cpp:52-127``)."""
        points = np.asarray(points, np.float64)
        single = points.ndim == 1
        if points.size == 0 and not single:
            return np.zeros(0)
        points = self._check_points(points)
        if self.alphas is None:
            raise PLSSVMError("No alphas provided for prediction!")

        alphas_dev = jnp.asarray(self.alphas.astype(self.dtype))
        ndev = self._num_devices()
        if self.kernel == KernelType.linear:
            # w fast path (gpu_csvm.cpp:83-91)
            if self.w_ is None:
                if self._use_sparse():
                    # w = X^T alpha through sparse BLAS; X never densifies
                    self.w_ = np.asarray(
                        self.data.csr.T @ self.alphas, np.float64
                    ).ravel()
                elif ndev > 1:
                    # multi-chip update_w (gpu_csvm.cpp:327-350): each chip
                    # contracts its row slice, psum replicates w
                    from ..parallel.sharded import make_sharded_w

                    X_sv, a_sv = self._padded_sv(ndev)
                    self.w_ = np.asarray(
                        make_sharded_w(self._mesh(ndev))(X_sv, a_sv), np.float64
                    )
                else:
                    self.w_ = np.asarray(
                        _w_jit(self._X_all_device(), alphas_dev), np.float64
                    )
            out = points @ self.w_ + self.bias_
        elif self._use_sparse():
            # kernel expansion from a host-assembled cross Gram (sparse SVs)
            from .sparse_learn import predict_from_cross_gram_jit

            csr = self.data.csr
            Gc = np.asarray((csr @ points.T).T, np.float64)
            sq_sv = np.asarray(csr.multiply(csr).sum(axis=1)).ravel()
            sq_p = np.sum(points * points, axis=1)
            out = np.asarray(
                predict_from_cross_gram_jit(
                    jnp.asarray(Gc.astype(self.dtype)),
                    jnp.asarray(sq_p.astype(self.dtype)),
                    jnp.asarray(sq_sv.astype(self.dtype)),
                    alphas_dev, jnp.asarray(self.bias_, self.dtype),
                    jnp.asarray(self.gamma, self.dtype),
                    jnp.asarray(self.coef0, self.dtype),
                    kernel=self.kernel, degree=self.degree,
                ),
                np.float64,
            )
        elif ndev > 1:
            # multi-chip kernel expansion: SV axis sharded, decision values
            # psummed (gpu_csvm.cpp:52-127 over all devices)
            from ..parallel.sharded import make_sharded_predict

            X_sv, a_sv = self._padded_sv(ndev)
            out = np.asarray(
                make_sharded_predict(self._mesh(ndev), self.kernel, self.degree)(
                    jnp.asarray(points.astype(self.dtype)), X_sv, a_sv,
                    jnp.asarray(self.bias_, self.dtype),
                    jnp.asarray(self.gamma, self.dtype),
                    jnp.asarray(self.coef0, self.dtype),
                ),
                np.float64,
            )
        else:
            out = np.asarray(
                _predict_jit(
                    jnp.asarray(points.astype(self.dtype)), self._X_all_device(),
                    alphas_dev, jnp.asarray(self.bias_, self.dtype),
                    jnp.asarray(self.gamma, self.dtype), jnp.asarray(self.coef0, self.dtype),
                    kernel=self.kernel, degree=self.degree,
                ),
                np.float64,
            )
        return out[0] if single else out

    def predict_label(self, points) -> np.ndarray:
        """sign(predict) (``csvm.cpp:343-366``; sign(0) = -1,
        ``operators.hpp:174-177``)."""
        values = self.predict(points)
        return np.where(np.asarray(values) > 0.0, 1.0, -1.0)

    def predict_parsed(self, parsed) -> np.ndarray:
        """Predict a :class:`~..io.libsvm.ParsedData` batch, staying sparse
        end-to-end when both the SVs and the points are sparse (neither is
        ever densified — beyond the reference, which densifies at parse)."""
        if self.alphas is None:
            raise PLSSVMError("No alphas provided for prediction!")
        if parsed.num_features != self.num_features:
            raise PLSSVMError(
                f"Number of features per data point ({self.num_features}) must match "
                f"the number of features per predict point ({parsed.num_features})!"
            )
        sparse_points = parsed.density <= float(self.params.sparse_threshold)
        if not (self._use_sparse() and sparse_points):
            return self.predict(parsed.dense)

        csr_p = parsed.csr
        if self.kernel == KernelType.linear:
            if self.w_ is None:
                self.w_ = np.asarray(self.data.csr.T @ self.alphas, np.float64).ravel()
            return np.asarray(csr_p @ self.w_, np.float64).ravel() + self.bias_

        from .sparse_learn import predict_from_cross_gram_jit
        from ..ops.sparse import host_cross_gram_from_csr

        Gc = host_cross_gram_from_csr(csr_p, self.data.csr)
        sq_p = np.asarray(csr_p.multiply(csr_p).sum(axis=1)).ravel()
        sq_sv = np.asarray(self.data.csr.multiply(self.data.csr).sum(axis=1)).ravel()
        return np.asarray(
            predict_from_cross_gram_jit(
                jnp.asarray(Gc.astype(self.dtype)),
                jnp.asarray(sq_p.astype(self.dtype)),
                jnp.asarray(sq_sv.astype(self.dtype)),
                jnp.asarray(self.alphas.astype(self.dtype)),
                jnp.asarray(self.bias_, self.dtype),
                jnp.asarray(self.gamma, self.dtype),
                jnp.asarray(self.coef0, self.dtype),
                kernel=self.kernel, degree=self.degree,
            ),
            np.float64,
        )

    def predict_label_parsed(self, parsed) -> np.ndarray:
        return np.where(self.predict_parsed(parsed) > 0.0, 1.0, -1.0)

    # --------------------------------------------------------------- accuracy

    def accuracy(self, points=None, labels=None) -> float:
        """Fraction of sign-correct predictions (``csvm.cpp:270-318``)."""
        if points is None:
            if self.values is None:
                raise PLSSVMError(
                    "No labels given! Maybe the data is only usable for prediction?"
                )
            if self._use_sparse():
                predictions = self.predict_parsed(self.data)
                correct = int(np.sum(predictions * np.asarray(self.values) > 0.0))
                return correct / self.num_data_points
            points, labels = self.data.dense, self.values
        if labels is None:
            # loud PLSSVMError instead of numpy's raw TypeError
            # (error-contract parity, csvm.cpp:270-318)
            raise PLSSVMError(
                "No labels given! Maybe the data is only usable for prediction?"
            )
        points = np.asarray(points, np.float64)
        labels = np.atleast_1d(np.asarray(labels, np.float64))
        if points.ndim == 1:
            points = points[None, :]
        if len(points) != len(labels):
            raise PLSSVMError(
                f"Number of data points ({len(points)}) must match number of "
                f"correct labels ({len(labels)})!"
            )
        if len(points) == 0:
            return 0.0
        predictions = self.predict(points)
        correct = int(np.sum(predictions * labels > 0.0))
        return correct / len(points)

    # ------------------------------------------------------------ write_model

    def write_model(self, model_name: str) -> None:
        """Write the LIBSVM model checkpoint (``csvm.cpp:60-204``)."""
        if self.alphas is None:
            raise PLSSVMError("No alphas given! Maybe a call to 'learn()' is missing?")
        if self.values is None:
            raise PLSSVMError("No labels given! Maybe the data is only usable for prediction?")
        if self.num_data_points != len(self.values):
            raise PLSSVMError(
                f"Number of labels ({len(self.values)}) must match the number of "
                f"data points ({self.num_data_points})!"
            )

        start = time.perf_counter()
        header = write_model_file(
            model_name,
            kernel=self.kernel,
            rho=-self.bias_,
            data=self.data.csr if self._use_sparse() else self.data.dense,
            labels=self.values,
            alphas=self.alphas,
            degree=self.degree,
            gamma=self.gamma,
            coef0=self.coef0,
        )
        if self.print_info:
            print(f"\nOptimization finished\n{header}")
            n_sv = int(np.sum(self.values > 0)) + int(np.sum(self.values < 0))
            elapsed = (time.perf_counter() - start) * 1000.0
            print(
                f"Wrote model file ('{model_name}') with {n_sv} support vectors "
                f"in {elapsed:.0f}ms."
            )
