"""Sparse (CSR/ELL) feature-matrix support — the capability the fork name
promises.

The reference always densifies parsed sparse data
(``include/plssvm/parameter.hpp:51-75`` "the parsed output is always in a
dense format"), so a dataset like news20 (f ~ 1.3M, density ~0.03%) simply
does not fit.  Here the CSR form survives parsing (``io/libsvm.py``) and
feeds sparse execution on the device:

- **ELL packing**: rows padded to the max nonzeros-per-row, giving static
  shapes (``values``/``cols`` of shape (n, L)) that XLA can tile — the
  static-shape answer to CSR's ragged rows (SURVEY.md §7 step 5 "ELL
  packing").
- **linear-kernel matvec**: ``K v = X (X^T v)`` with both products
  nnz-proportional: a row-gather product for ``X u`` and a
  ``segment_sum`` scatter for ``X^T v``.  Fully implicit — O(nnz) memory,
  every CG iteration on device.
- **poly/RBF over sparse features**: three memory-guarded tiers (see
  ``models/base.py _learn_sparse``): one-shot Gram assembly (device
  blockwise GEMM or host SpGEMM) for cached-mode CG; densify-X-only onto
  the implicit matvec; and the fully streaming matvecs that recompute
  kernel blocks from the packing every iteration at O(n·L) memory — the
  only option when even dense X exceeds device memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax import lax

from .kernel_functions import PRECISION, gram_block


@dataclass
class ELLMatrix:
    """ELLPACK: row-major nonzeros padded to a uniform row length.

    ``values[i, l]`` / ``cols[i, l]`` hold the l-th nonzero of row i; padding
    slots have value 0 and column 0 (harmless: 0 * anything).
    """

    values: jnp.ndarray  # (n, L)
    cols: jnp.ndarray  # (n, L) int32
    shape: tuple[int, int]

    @property
    def row_capacity(self) -> int:
        return self.values.shape[1]

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32, pad_rows: int | None = None) -> "ELLMatrix":
        """Pack a scipy CSR matrix; optionally zero-pad to ``pad_rows`` rows."""
        n, f = csr.shape
        rows_out = pad_rows if pad_rows is not None else n
        nnz_per_row = np.diff(csr.indptr)
        L = max(1, int(nnz_per_row.max()) if n else 1)
        values = np.zeros((rows_out, L), dtype=dtype)
        cols = np.zeros((rows_out, L), dtype=np.int32)
        # vectorized scatter: entry k of the CSR stream lands at
        # (row(k), k - row_start(row(k)))
        rows = np.repeat(np.arange(n), nnz_per_row)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
        values[rows, pos] = csr.data
        cols[rows, pos] = csr.indices
        return ELLMatrix(
            values=jnp.asarray(values), cols=jnp.asarray(cols), shape=(rows_out, f)
        )


def ell_matvec(ell: ELLMatrix, u: jnp.ndarray) -> jnp.ndarray:
    """X @ u for dense u (f,): gather u at each nonzero column, row-sum.

    nnz-proportional; the gather vectorizes over the static (n, L) layout.
    """
    gathered = u[ell.cols]  # (n, L)
    return jnp.sum(ell.values * gathered, axis=1)


def ell_rmatvec(ell: ELLMatrix, v: jnp.ndarray) -> jnp.ndarray:
    """X^T @ v for dense v (n,): scatter-add row contributions per column."""
    n, f = ell.shape
    contributions = (ell.values * v[:, None]).reshape(-1)  # (n*L,)
    flat_cols = ell.cols.reshape(-1)
    return jax.ops.segment_sum(contributions, flat_cols, num_segments=f)


def ell_row_sqnorms(ell: ELLMatrix) -> jnp.ndarray:
    """Row squared norms (for RBF distance expansion)."""
    return jnp.sum(ell.values * ell.values, axis=1)


@dataclass
class HybridSparse:
    """ELL + COO hybrid: rows are ELL-packed up to a capped row length and
    the overflow nonzeros of skewed rows spill into a static COO tail.

    Fixes the ELL worst case (one dense row inflating every row's padding to
    f): memory is ``n * Lcap + 3 * overflow`` instead of ``n * max_nnz``.
    The cap is chosen to minimize that sum over the actual nnz histogram.
    """

    ell: ELLMatrix
    coo_rows: jnp.ndarray  # (m,) int32
    coo_cols: jnp.ndarray  # (m,) int32
    coo_vals: jnp.ndarray  # (m,)

    @property
    def shape(self) -> tuple[int, int]:
        return self.ell.shape

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32,
                 pad_rows: int | None = None) -> "HybridSparse":
        n, f = csr.shape
        nnz_per_row = np.diff(csr.indptr)
        max_l = int(nnz_per_row.max()) if n else 0
        # pick Lcap minimizing ELL + COO footprint: n*L + 3*sum(max(0, nnz-L))
        counts = np.bincount(nnz_per_row, minlength=max_l + 1)
        tail = np.cumsum(counts[::-1])[::-1]  # tail[L] = #rows with nnz >= L
        suffix = np.concatenate([np.cumsum(tail[::-1])[::-1], [0]])
        overflow = suffix[1:]  # overflow[L] = sum_i max(0, nnz_i - L)
        Ls = np.arange(max_l + 1)
        costs = n * Ls + 3 * overflow
        Lcap = max(1, int(Ls[np.argmin(costs)]))

        rows_out = pad_rows if pad_rows is not None else n
        values = np.zeros((rows_out, Lcap), dtype=dtype)
        cols = np.zeros((rows_out, Lcap), dtype=np.int32)
        rows = np.repeat(np.arange(n), nnz_per_row)
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
        in_ell = pos < Lcap
        values[rows[in_ell], pos[in_ell]] = csr.data[in_ell]
        cols[rows[in_ell], pos[in_ell]] = csr.indices[in_ell]
        ell = ELLMatrix(values=jnp.asarray(values), cols=jnp.asarray(cols),
                        shape=(rows_out, f))
        tail_sel = ~in_ell
        # nonzero conservation (ELL cells + COO tail == csr.nnz) holds by
        # construction of the in_ell partition; the reconstruction-roundtrip
        # property is covered by tests (test_sparse.py matvec-parity suite)
        return HybridSparse(
            ell=ell,
            coo_rows=jnp.asarray(rows[tail_sel].astype(np.int32)),
            coo_cols=jnp.asarray(csr.indices[tail_sel].astype(np.int32)),
            coo_vals=jnp.asarray(csr.data[tail_sel].astype(dtype)),
        )


def hybrid_matvec(h: HybridSparse, u: jnp.ndarray) -> jnp.ndarray:
    """X @ u over the ELL part + COO tail (nnz-proportional)."""
    out = ell_matvec(h.ell, u)
    if h.coo_vals.shape[0]:
        n = h.ell.shape[0]
        out = out + jax.ops.segment_sum(
            h.coo_vals * u[h.coo_cols], h.coo_rows, num_segments=n)
    return out


def hybrid_rmatvec(h: HybridSparse, v: jnp.ndarray) -> jnp.ndarray:
    """X^T @ v over the ELL part + COO tail."""
    out = ell_rmatvec(h.ell, v)
    if h.coo_vals.shape[0]:
        f = h.ell.shape[1]
        out = out + jax.ops.segment_sum(
            h.coo_vals * v[h.coo_rows], h.coo_cols, num_segments=f)
    return out


def hybrid_row_sqnorms(h: HybridSparse) -> jnp.ndarray:
    out = ell_row_sqnorms(h.ell)
    if h.coo_vals.shape[0]:
        n = h.ell.shape[0]
        out = out + jax.ops.segment_sum(
            h.coo_vals * h.coo_vals, h.coo_rows, num_segments=n)
    return out


@dataclass
class TiledELL:
    """Lane-tiled ELL: each row's nonzeros are bucketed per 128-wide column
    tile and padded to the worst per-(row, tile) fill ``Lt``.

    This is the packing that makes *scatter-free* densification possible:
    a (rows, tile) bucket densifies with a broadcast compare against the
    iota (``lcols == iota(128)``) — elementwise work, ``Lt`` ops per dense
    element, no XLA scatter anywhere (whether a plain scatter-densify is
    now cheaper on the GPU, where scatters run with atomics, is ROADMAP
    A3).

    Storage is ``rows * ntiles * Lt`` values+int32 local columns; since
    ``Lt <= 128`` it never exceeds the 128-padded dense size, and for
    moderate uniform sparsity ``Lt`` sits close to the per-tile fill (a few
    slots).  Padding slots carry value 0 / lcol 0 (harmless).  The extreme-
    sparsity regime (fill orders of magnitude below one slot per tile, e.g.
    news20) stays on the nnz-proportional ``gather`` strategy instead.
    """

    vals: jnp.ndarray  # (rows, ntiles * Lt)
    lcols: jnp.ndarray  # (rows, ntiles * Lt) int32 in [0, 128)
    shape: tuple[int, int]  # logical (rows, f)
    ntiles: int
    Lt: int

    @property
    def padded_features(self) -> int:
        return self.ntiles * 128

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32,
                 pad_rows: int | None = None) -> "TiledELL":
        tell, heavy_idx, _ = pack_tiled_hybrid(
            csr, dtype=dtype, pad_rows=pad_rows, cap=None)
        assert heavy_idx.size == 0  # cap=None packs every row
        return tell


@dataclass
class TiledHybrid:
    """Tiled-ELL light rows + a small DENSE block of heavy rows.

    The tiled-ELL capacity ``Lt`` pads every (row, tile) bucket to the
    worst fill; one dense-ish row would inflate it to 128 — up to ~2x the
    padded-dense size (the skew failure HybridSparse's COO tail solved for
    plain ELL).  Here ``Lt`` is capped at the memory-optimal value over the
    row-max-fill histogram and the few rows exceeding it are carried as
    DENSE (h, ntiles*128) rows instead: densified panels place them with
    row-slice updates (still zero scatter), and their O(n)-vector
    contributions (sq, g_last) are host-precomputed.  Memory is
    ``rows*ntiles*Lt + h*fp`` — bounded, skew-robust.
    """

    tell: TiledELL  # light rows (heavy rows zeroed inside)
    heavy_idx: np.ndarray  # (h,) HOST int array — static row positions
    heavy: jnp.ndarray  # (h, ntiles*128) dense heavy rows

    @staticmethod
    def from_csr(csr: sp.csr_matrix, dtype=np.float32,
                 pad_rows: int | None = None) -> "TiledHybrid":
        tell, heavy_idx, heavy = pack_tiled_hybrid(
            csr, dtype=dtype, pad_rows=pad_rows)
        return TiledHybrid(tell=tell, heavy_idx=heavy_idx,
                           heavy=jnp.asarray(heavy))

    @property
    def cells(self) -> int:
        """Storage in f32-equivalents: each light slot carries a value AND
        an int32 local column (2 units); heavy cells carry 1."""
        return 2 * self.tell.vals.size + self.heavy.size


def pack_tiled_hybrid(csr: sp.csr_matrix, dtype=np.float32,
                      pad_rows: int | None = None, cap: int | None = 0):
    """Pack a CSR into (TiledELL light rows, heavy_idx, heavy_dense).

    ``cap=None`` disables the heavy split (Lt = global max fill);
    ``cap=0`` (default) picks the memory-optimal Lt over the row-max-fill
    histogram: minimize ``rows*ntiles*Lt + h(Lt)*ntiles*128`` where
    ``h(Lt)`` counts rows whose worst tile fill exceeds Lt.
    """
    csr = csr.tocsr()
    csr.sum_duplicates()
    csr.sort_indices()
    n, f = csr.shape
    rows_out = pad_rows if pad_rows is not None else n
    ntiles = max(1, -(-f // 128))
    nnz_per_row = np.diff(csr.indptr)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = csr.indices
    tile = cols // 128
    lcol = (cols % 128).astype(np.int32)
    # slot position within each (row, tile) bucket: indices are sorted
    # per row, so bucket entries are contiguous in the CSR stream
    key = rows.astype(np.int64) * ntiles + tile
    if key.size:
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        bucket_start = np.repeat(starts, np.diff(np.r_[starts, key.size]))
        slot = np.arange(key.size) - bucket_start
        bucket_fill = slot + 1
        # worst tile fill per row
        rowmax = np.zeros(n, np.int64)
        np.maximum.at(rowmax, rows, bucket_fill)
        max_fill = int(bucket_fill.max())
    else:
        slot = np.zeros(0, np.int64)
        rowmax = np.zeros(n, np.int64)
        max_fill = 1

    if cap is None or max_fill <= 1:
        Lt = max(1, max_fill)
        heavy_mask = np.zeros(n, bool)
    else:
        # memory-optimal cap over the rowmax histogram, in bytes: a light
        # slot costs a value + an int32 column (itemsize + 4 bytes), a
        # heavy dense cell costs itemsize (a fixed 2:1 ratio would be the
        # f32 special case; f64's true ratio is 1.5:1)
        itemsize = np.dtype(dtype).itemsize
        counts = np.bincount(rowmax, minlength=max_fill + 1)
        rows_above = counts[::-1].cumsum()[::-1]  # rows with rowmax >= k
        cands = np.arange(1, max_fill + 1)
        # h(Lt) = #rows with rowmax > Lt = rows_above[Lt + 1]
        h = np.concatenate([rows_above[2:], [0]])
        cost = (rows_out * ntiles * cands * (itemsize + 4)
                + h * (ntiles * 128) * itemsize)
        Lt = int(cands[np.argmin(cost)]) if cap == 0 else min(int(cap), max_fill)
        heavy_mask = rowmax > Lt

    heavy_idx = np.flatnonzero(heavy_mask)
    light_sel = ~heavy_mask[rows] if rows.size else np.zeros(0, bool)
    vals = np.zeros((rows_out, ntiles * Lt), dtype=dtype)
    lcols = np.zeros((rows_out, ntiles * Lt), dtype=np.int32)
    pos = tile * Lt + slot
    vals[rows[light_sel], pos[light_sel]] = csr.data[light_sel]
    lcols[rows[light_sel], pos[light_sel]] = lcol[light_sel]
    heavy = np.zeros((len(heavy_idx), ntiles * 128), dtype=dtype)
    if len(heavy_idx):
        heavy[:, :f] = csr[heavy_idx].toarray()
    tell = TiledELL(vals=jnp.asarray(vals), lcols=jnp.asarray(lcols),
                    shape=(rows_out, f), ntiles=ntiles, Lt=Lt)
    return tell, heavy_idx, heavy


def densify_tiled(vals, lcols, ntiles: int, Lt: int):
    """Densify a tiled-ELL slab (m, ntiles*Lt) -> (m, ntiles*128) with the
    broadcast-compare trick — NO scatter: ``out[:, t, c] = sum_l vals[:, t, l]
    * (lcols[:, t, l] == c)``.  ``Lt`` fused elementwise passes over the dense
    output; XLA never materializes the (m, ntiles, Lt, 128) intermediate
    because the slot loop is unrolled into accumulating adds."""
    m = vals.shape[0]
    V = vals.reshape(m, ntiles, Lt)
    C = lcols.reshape(m, ntiles, Lt)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 128), 2)
    out = jnp.zeros((m, ntiles, 128), vals.dtype)
    for l in range(Lt):
        out = out + V[:, :, l:l + 1] * (C[:, :, l:l + 1] == lane)
    return out.reshape(m, ntiles * 128)


def tiled_global_cols(ntiles: int, Lt: int):
    """Per-slot tile base offsets: global col = lcols + base (static)."""
    return (jnp.arange(ntiles * Lt, dtype=jnp.int32) // Lt) * 128


def tiled_matvec(tell_vals, tell_lcols, u, ntiles: int, Lt: int):
    """X @ u from the tiled packing for a dense u of length >= ntiles*128
    (zero-padded): gather + row sum, nnz-proportional (padding slots hit
    the tile base with value 0)."""
    gcols = tell_lcols + tiled_global_cols(ntiles, Lt)[None, :]
    return jnp.sum(tell_vals * u[gcols], axis=1)


def stream_panel_rows(D: int, fp: int, itemsize: int, budget_bytes: int) -> int:
    """Row count of the transient dense panels of the ``panel`` streaming
    strategy.  During one panel-pair contribution ~4 panel-sized f32 buffers
    are live (two dense panels + their bf16 hi/lo splits); a safety factor
    of 2 covers XLA temporaries.  Floor of 256 rows keeps tiny budgets
    functional (the guard is a budget, not a hard allocator limit)."""
    per_row = max(1, 8 * fp * itemsize)
    C = budget_bytes // per_row
    C = max(256, (C // 256) * 256)
    return min(D, C)


def pair_gram_contrib(kernel, Xi, Xj, v_i, v_j, *, same: bool, sq_i=None,
                      sq_j=None, degree: int = 3, gamma=1.0, coef0=0.0,
                      precision=None):
    """Panel-pair contributions of ``K = k(Xi, Xj)``: one GEMM and the
    kernel function build the (Di, Dj) block, two GEMVs use it.

    Returns ``(out_i, out_j)`` with ``out_i = K @ v_j`` and, for a cross
    pair (``same=False``), ``out_j = K^T @ v_i``; a diagonal pair
    (``same=True``, ``Xj is Xi``) returns zeros for ``out_j``, so adding
    both outputs into the panels' slots gives ``K(X, X) @ v`` either way.
    Padding rows must be zero with zero ``v`` entries."""
    K = gram_block(kernel, Xi, Xj, degree, gamma, coef0,
                   Xi_sqnorm=sq_i, Xj_sqnorm=sq_j, precision=precision)
    dtype = Xi.dtype
    out_i = jnp.dot(K, v_j.astype(dtype), preferred_element_type=dtype,
                    precision=PRECISION)
    if same:
        return out_i, jnp.zeros_like(v_j, dtype)
    out_j = jnp.dot(K.T, v_i.astype(dtype), preferred_element_type=dtype,
                    precision=PRECISION)
    return out_i, out_j


def make_tiled_panel_matvec(tell_vals, tell_lcols, kernel_int: int,
                            degree: int, gamma, coef0, *, ntiles: int,
                            Lt: int, panel_rows: int,
                            heavy=None, heavy_rows: tuple = (),
                            heavy_sq_vec=None, precision=None):
    """``v -> K(X, X) @ v`` for tiled-ELL-packed X via transient dense
    panels — the streaming north-star path rebuilt scatter-free:

    1. rows are cut into panels of ``panel_rows`` (budget-sized; the full
       dense X never exists),
    2. per CG iteration each needed panel densifies on the fly
       (:func:`densify_tiled`, compare-trick — ~``Lt`` elementwise ops per
       element, a few % of the pair product's GEMM time),
    3. every lower-triangular panel pair runs :func:`pair_gram_contrib`:
       one GEMM + kernel function builds the pair's block, which serves
       BOTH directions — triangular FLOPs over the panel grid.

    Heavy rows (skew spill, :class:`TiledHybrid`): ``heavy`` carries the
    dense rows, ``heavy_rows`` their static positions; panels place them
    with row-slice updates after the compare-densify (zero scatter), and
    ``heavy_sq_vec`` (host-precomputed, zero at light rows) completes the
    squared norms.

    Memory: O(rows * ntiles * Lt + h * f) resident.  Transients: XLA
    schedules the unrolled pair sweep for speed and keeps densified panels
    and pair blocks live — a peak of a few times the padded-dense bytes
    (the 4x envelope of :func:`panel_sweep_strategy`; re-measure it on the
    GPU with ``memory_analysis``).  Every pair is traced inline, so this
    schedule serves at most :data:`MAX_UNROLLED_PAIRS` pairs;
    :func:`make_tiled_panel_matvec_windowed` serves the rest.  Returns
    ``(matvec, sq)``.
    """
    from ..types import KernelType

    kernel = KernelType(kernel_int)
    D = tell_vals.shape[0]
    bounds = list(range(0, D, panel_rows)) + [D]  # ragged last panel is fine
    nP = len(bounds) - 1
    sq = jnp.sum(tell_vals * tell_vals, axis=1)
    if heavy_sq_vec is not None:
        sq = sq + heavy_sq_vec

    def densify(lo, hi):
        base = densify_tiled(tell_vals[lo:hi], tell_lcols[lo:hi], ntiles, Lt)
        for k, r in enumerate(heavy_rows):  # static positions, static loop
            if lo <= r < hi:
                base = jax.lax.dynamic_update_slice(
                    base, heavy[k:k + 1].astype(base.dtype), (r - lo, 0))
        return base

    def matvec(v):
        v = v.astype(tell_vals.dtype)
        outs = [jnp.zeros((bounds[p + 1] - bounds[p],), tell_vals.dtype)
                for p in range(nP)]
        for I in range(nP):
            loI, hiI = bounds[I], bounds[I + 1]
            XdI = densify(loI, hiI)
            vi, sqi = v[loI:hiI], sq[loI:hiI]
            for J in range(I + 1):
                loJ, hiJ = bounds[J], bounds[J + 1]
                same = J == I
                XdJ = XdI if same else densify(loJ, hiJ)
                vj, sqj = v[loJ:hiJ], sq[loJ:hiJ]
                oi, oj = pair_gram_contrib(
                    kernel, XdI, XdJ, vi, vj, same=same, sq_i=sqi, sq_j=sqj,
                    degree=degree, gamma=gamma, coef0=coef0,
                    precision=precision)
                outs[I] = outs[I] + oi
                outs[J] = outs[J] + oj
        return jnp.concatenate(outs) if nP > 1 else outs[0]

    return matvec, sq


#: most panel-pair products one sweep traces inline.  The unrolled sweep
#: compiles one GEMM and kernel function per pair: on an H100, 10 pairs
#: (16384x4096 f64, four panels) compiled and ran in 13.5 s, while a ring
#: hop of 256 products did not finish compiling in six minutes.  Above
#: this count the scanned (``windowed``) sweep traces one pair whatever
#: the panel count (docs/PERF.md, ROADMAP C7).
MAX_UNROLLED_PAIRS = 16


def panel_sweep_strategy(pairs: int, dense_bytes: int | None = None,
                         physical_bytes: int | None = None) -> str:
    """Pair-sweep schedule of the ``panel`` streaming matvec, for a sweep
    of ``pairs`` panel-pair products:

    - ``unrolled`` — every panel pair traced inline; XLA CSE densifies each
      panel once per sweep but its scheduler keeps panels and pair blocks
      live across the sweep (a peak of up to ~4x the padded-dense bytes),
      and compile time grows with the pair count.
    - ``windowed`` — ``lax.scan`` over the panel pairs: liveness is
      structurally bounded, so the BUDGET sizes the transient instead of
      the dense size, and one pair is traced whatever the panel count.
      Slower per pair (no whole-sweep CSE of the densified panels).

    ``PLSSVM_SPARSE_PANEL_SWEEP`` forces either.  Auto picks ``windowed``
    when the unrolled ~4x-dense envelope exceeds the device's physical
    memory (when a memory context is given) or the sweep has more than
    :data:`MAX_UNROLLED_PAIRS` pairs, else ``unrolled``.
    """
    forced = os.environ.get("PLSSVM_SPARSE_PANEL_SWEEP", "auto")
    if forced in ("unrolled", "windowed"):
        return forced
    if (dense_bytes is not None and physical_bytes is not None
            and 4 * dense_bytes > physical_bytes):
        return "windowed"
    return "windowed" if pairs > MAX_UNROLLED_PAIRS else "unrolled"


def make_tiled_panel_matvec_windowed(tell_vals, tell_lcols, kernel_int: int,
                                     degree: int, gamma, coef0, *, ntiles: int,
                                     Lt: int, panel_rows: int,
                                     heavy=None, heavy_rows: tuple = (),
                                     heavy_sq_vec=None, precision=None):
    """``v -> K(X, X) @ v`` for tiled-ELL-packed X — the ``windowed``
    pair-sweep schedule (see :func:`panel_sweep_strategy`): bounded-liveness
    streaming for the beyond-device-memory single-device regime
    (BASELINE.json config 3; the reference cannot load this regime at all,
    ``parameter.hpp:51-75``).

    Two scans per matvec:

    1. diagonal panels: densify panel ``i``, run the triangular pair kernel
       on it (``same=True`` — no double-counted blocks);
    2. strict-lower cross pairs in i-major order: the carry holds the
       densified i-panel, re-densified only when ``i`` advances
       (``lax.cond``), so each i-panel's densify amortizes over its whole
       j-sweep while the scan structurally frees every j-panel after its
       pair — XLA cannot keep the whole sweep's panels live the way the
       unrolled schedule lets it.

    Panels are uniform (``panel_rows`` rows); the packed arrays are padded
    to a panel multiple with inert zero rows.  Returns ``(matvec, sq)``
    like :func:`make_tiled_panel_matvec`.
    """
    from ..types import KernelType

    kernel = KernelType(kernel_int)
    dtype = tell_vals.dtype
    D = tell_vals.shape[0]
    P = min(panel_rows, D)
    nP = -(-D // P)
    Dp = nP * P
    fp = ntiles * 128
    slots = ntiles * Lt
    if Dp != D:
        tell_vals = jnp.zeros((Dp, slots), dtype).at[:D].set(tell_vals)
        tell_lcols = jnp.zeros((Dp, slots), jnp.int32).at[:D].set(tell_lcols)

    sq = jnp.sum(tell_vals * tell_vals, axis=1)
    if heavy_sq_vec is not None:
        hs = (heavy_sq_vec if Dp == D
              else jnp.zeros((Dp,), dtype).at[:D].set(heavy_sq_vec))
        sq = sq + hs
    # heavy rows grouped BY PANEL on the host (panels are uniform, so the
    # grouping is static): each densify places only ITS panel's rows —
    # without this, every densify in the scan body carried one gated
    # update per GLOBAL heavy row (837 heavy rows at a 65536x32768 @0.5%
    # config made the scan body ~40x larger)
    h = len(heavy_rows)
    if h:
        groups = [[] for _ in range(nP)]
        for k, r in enumerate(heavy_rows):
            groups[int(r) // P].append(k)
        hmax = max(len(g) for g in groups)
        sel = np.zeros((nP, hmax), np.int32)  # index into `heavy`
        loc = np.full((nP, hmax), P, np.int32)  # local row; P = inert
        for p_, g in enumerate(groups):
            for j, k in enumerate(g):
                sel[p_, j] = k
                loc[p_, j] = int(heavy_rows[k]) - p_ * P
        # per-panel heavy rows gathered once (nP, hmax, fp)
        hv_panel = heavy[jnp.asarray(sel)].astype(dtype)
        loc_panel = jnp.asarray(loc)
    else:
        hmax = 0

    def densify_dyn(p_idx):
        """Densify panel ``p_idx`` (traced scan index); this panel's heavy
        rows place with gated read-modify-write row slices (the
        traced-position twin of the unrolled schedule's static placement;
        heavy rows' zeroed light slots make a replace semantically exact)."""
        zero = jnp.asarray(0, jnp.int32)
        lo = p_idx * P
        Vp = lax.dynamic_slice(tell_vals, (lo, zero), (P, slots))
        Cp = lax.dynamic_slice(tell_lcols, (lo, zero), (P, slots))
        base = densify_tiled(Vp, Cp, ntiles, Lt)
        if hmax:
            hv = lax.dynamic_index_in_dim(hv_panel, p_idx, keepdims=False)
            hloc = lax.dynamic_index_in_dim(loc_panel, p_idx, keepdims=False)
            for k in range(hmax):
                idx = jnp.clip(hloc[k], 0, P - 1).astype(jnp.int32)
                valid = hloc[k] < P
                cur = lax.dynamic_slice(base, (idx, zero), (1, fp))
                row = jnp.where(valid, hv[k:k + 1], cur)
                base = lax.dynamic_update_slice(base, row, (idx, zero))
        return base

    fn = pair_gram_contrib
    kw = dict(degree=degree, gamma=gamma, coef0=coef0, precision=precision)

    # i-major strict-lower pair order (static tables, traced through scan)
    tri = [(i, j) for i in range(nP) for j in range(i)]
    pair_i = jnp.asarray([t[0] for t in tri], jnp.int32)
    pair_j = jnp.asarray([t[1] for t in tri], jnp.int32)

    def matvec(v):
        v = v.astype(dtype)
        v_pad = v if Dp == D else jnp.zeros((Dp,), dtype).at[:D].set(v)

        def vslice(lo):
            return (lax.dynamic_slice(v_pad, (lo,), (P,)),
                    lax.dynamic_slice(sq, (lo,), (P,)))

        def out_add(out, lo, contrib):
            seg = lax.dynamic_slice(out, (lo,), (P,))
            return lax.dynamic_update_slice(out, seg + contrib, (lo,))

        def diag_step(out, i):
            lo = i * P
            Xd = densify_dyn(i)
            vi, sqi = vslice(lo)
            oi, oj = fn(kernel, Xd, Xd, vi, vi, same=True, sq_i=sqi,
                        sq_j=sqi, **kw)
            return out_add(out, lo, oi + oj), None

        out, _ = lax.scan(diag_step, jnp.zeros((Dp,), dtype),
                          jnp.arange(nP, dtype=jnp.int32))

        if nP > 1:
            def cross_step(carry, pij):
                icur, Xi, out = carry
                i, j = pij
                lo_i, lo_j = i * P, j * P
                Xi = lax.cond(i != icur,
                              lambda _: densify_dyn(i),
                              lambda _: Xi, None)
                Xj = densify_dyn(j)
                vi, sqi = vslice(lo_i)
                vj, sqj = vslice(lo_j)
                oi, oj = fn(kernel, Xi, Xj, vi, vj, same=False, sq_i=sqi,
                            sq_j=sqj, **kw)
                out = out_add(out, lo_i, oi)
                out = out_add(out, lo_j, oj)
                return (i, Xi, out), None

            init = (jnp.int32(-1), jnp.zeros((P, fp), dtype), out)
            (_, _, out), _ = lax.scan(cross_step, init, (pair_i, pair_j))

        return out[:D]

    return matvec, sq[:D]


def host_gram_from_csr(csr: sp.csr_matrix, dept: int | None = None) -> np.ndarray:
    """Dense Gram G = X X^T computed with scipy sparse BLAS (host, f64).

    Used to set up cached-mode CG for poly/RBF kernels over sparse features:
    X itself is never densified; only the (dept, dept) Gram is materialized.
    """
    Xs = csr if dept is None else csr[:dept]
    return np.asarray((Xs @ Xs.T).todense(), dtype=np.float64)


def host_cross_gram_from_csr(csr_a: sp.csr_matrix, csr_b: sp.csr_matrix) -> np.ndarray:
    """Dense cross Gram A B^T on the host (predict path over sparse data)."""
    return np.asarray((csr_a @ csr_b.T).todense(), dtype=np.float64)


def device_gram_from_ell(ell: ELLMatrix) -> jnp.ndarray:
    """Dense Gram ``G = X X^T`` assembled on device from the ELL packing:
    one O(nnz) scatter densifies X (transient (n, f) buffer, budget-gated
    by the caller) and one big GEMM builds G.

    A blockwise-pair variant would keep peak memory at two dense blocks
    but re-densify every column block O(nb) times through nb² scatters.
    Since the caller only takes this path when the
    (n, n) Gram itself fits the memory budget, a transient (n, f) dense X
    (smaller than G whenever f < n) is an acceptable peak; truly wide data
    routes to the host SpGEMM (:func:`host_gram_from_csr`).
    """
    n, f = ell.shape
    row_idx = jnp.arange(n)[:, None]
    X = jnp.zeros((n, f), ell.values.dtype).at[row_idx, ell.cols].add(ell.values)
    return jnp.dot(X, X.T, preferred_element_type=X.dtype, precision=PRECISION)


def _transform_block(kernel_int: int, G, sq_i, sq_j, degree, gamma, coef0):
    """Kernel transform of a streamed Gram block (kernel_types.hpp:69-84).
    ``kernel_int``: 0 linear, 1 polynomial, 2 rbf."""
    if kernel_int == 0:
        return G
    if kernel_int == 1:
        return jax.lax.integer_pow(gamma * G + coef0, degree)
    d2 = sq_i[:, None] + sq_j[None, :] - 2.0 * G
    return jnp.exp(-gamma * jnp.maximum(d2, 0.0))


def streaming_stream_strategy(L: int, f: int) -> str:
    """Pick the streaming contraction strategy: ``panel`` densifies
    transient row panels scatter-free (tiled-ELL compare trick) and runs
    the panel-pair GEMMs (O(n²·f) FLOPs, O(panel·f) transient memory);
    ``gather`` contracts ELL slots against the panel elementwise
    (O(nnz·bn) ops).  GEMMs run about two orders of magnitude faster per
    operation than gathers, so ``gather`` only wins at extreme sparsity —
    roughly row fill below f/1024 (news20-scale: f ~ 1.3M, density 0.03%;
    the rule predates the GPU and is to be re-derived there, ROADMAP A3).
    ``PLSSVM_SPARSE_STREAM`` forces either."""
    forced = os.environ.get("PLSSVM_SPARSE_STREAM", "auto")
    if forced in ("panel", "gather"):
        return forced
    return "gather" if L * 1024 < f else "panel"


def make_streaming_gram_matvec(h: HybridSparse, kernel_int: int, degree: int,
                               gamma, coef0, *, bm: int | None = None,
                               bn: int | None = None):
    """``v -> K(X, X) @ v`` streamed from the ELL+COO packing with the
    nnz-proportional ``gather`` contraction — the extreme-sparsity arm of
    the streaming tier (O(n·L) resident memory, the (n, n) kernel matrix
    and the (n, f) dense data are NEVER materialized; closes the
    reference's always-densify capability gap, ``parameter.hpp:51-75``).

    Every row block I contracts its ELL slots against the J panel with a
    vectorized gather — O(nnz_I · bn) elementwise work instead of O(bm · f · bn)
    GEMM FLOPs, the win when the row fill L is orders of magnitude below f
    (news20-scale data).  Moderate-density data takes the ``panel``
    strategy instead (:func:`make_tiled_panel_matvec` — transient
    scatter-free densified panels and one GEMM per panel pair).

    The fused kernel transform and the ``@ v_J`` epilogue run on the block
    while it is live, so per-iteration device-memory traffic stays O(n²·L̄/bn + n).

    Rows beyond the real data must be zero (zero slots contribute nothing).
    """
    n, f = h.shape
    strategy = "gather"
    if bm is None:
        bm = 512 if n % 512 == 0 else 128
    if bn is None:
        bn = 128  # rows that don't divide by 128 are rejected below anyway
    if n % bm != 0 or n % bn != 0:
        raise ValueError(f"padded rows {n} must divide by bm={bm}, bn={bn}")

    sq = hybrid_row_sqnorms(h)
    contrib = make_streaming_cross_contrib(
        kernel_int, degree, gamma, coef0,
        row_vals=h.ell.values, row_cols=h.ell.cols, row_sq=sq,
        row_trow=h.coo_rows, row_tcol=h.coo_cols, row_tval=h.coo_vals,
        f=f, bm=bm, bn=bn, strategy=strategy,
    )

    def matvec(v):
        return contrib(h.ell.values, h.ell.cols, h.coo_rows, h.coo_cols,
                       h.coo_vals, sq, v)

    return matvec, sq


def sparse_q_qa_kii(kernel_int: int, degree: int, gamma, coef0,
                    g_last, sq_last, sq, mask, cost_inv):
    """``q_i = k(x_i, x_last)``, ``QA_cost``, and the kernel diagonal
    ``kii`` from the linear building blocks — the ONE transform shared by
    the single-chip streaming learn and the ring-sharded learn (and valid
    shard-locally: all three outputs are row-local)."""
    from ..types import KernelType
    from .kernel_functions import kernel_diag

    kii = kernel_diag(KernelType(kernel_int), sq, degree, gamma, coef0)
    if kernel_int == 1:  # polynomial
        q = jax.lax.integer_pow(gamma * g_last + coef0, degree) * mask
        QA = jax.lax.integer_pow(gamma * sq_last + coef0, degree) + cost_inv
    elif kernel_int == 2:  # rbf
        d2 = sq + sq_last - 2.0 * g_last
        q = jnp.exp(-gamma * jnp.maximum(d2, 0.0)) * mask
        QA = jnp.asarray(1.0, g_last.dtype) + cost_inv
    else:  # linear
        q = g_last * mask
        QA = sq_last + cost_inv
    return q, QA, kii


def make_streaming_cross_contrib(kernel_int: int, degree: int, gamma, coef0,
                                 *, row_vals, row_cols, row_sq,
                                 row_trow, row_tcol, row_tval,
                                 f: int, bm: int, bn: int,
                                 strategy: str = "gather"):
    """Streaming cross-Gram ``gather`` contraction core shared by the
    single-chip streaming matvec and the ring-sharded multi-chip variant:

    ``contrib(panel_vals, panel_cols, panel_trow, panel_tcol, panel_tval,
    panel_sq, v) -> sum_j K(x_i^row, x_j^panel) v_j`` over all panel rows,
    for every row of the fixed ELL+COO *row side* closed over here.  The
    self-Gram case passes the row side's own arrays as the panel; the ring
    case passes the in-flight neighbor shard (panel row/tail indices are
    panel-local).  Padding rows/slots are zero and contribute nothing.

    Per J panel the columns are scatter-densified transposed ONCE (an XLA
    ``.at[].add``, ~O(nnz_J) elements per panel), then every row block I
    contracts its ELL slots against the panel with a vectorized gather —
    O(nnz_I · bn) elementwise work.  This is the extreme-sparsity arm, where nnz-proportional cost
    beats everything despite the scatter; moderate densities take the
    scatter-free GEMM ``panel`` strategy (:func:`make_tiled_panel_matvec`),
    which replaced the old dense-block scatter-densify branch.
    """
    if strategy != "gather":
        raise ValueError(
            f"unknown streaming contraction strategy '{strategy}' "
            "(the dense-block path moved to make_tiled_panel_matvec)")

    n_rows, L = row_vals.shape
    if n_rows % bm != 0:
        raise ValueError(f"row side {n_rows} must divide by bm={bm}")
    nI = n_rows // bm
    dtype = row_vals.dtype
    has_row_tail = int(row_tval.shape[0]) > 0
    Vb = row_vals.reshape(nI, bm, L)
    Cb = row_cols.reshape(nI, bm, L)
    sqb = row_sq.reshape(nI, bm)
    row_in_bn = jnp.arange(bn)[:, None]  # (bn, 1) broadcast vs (bn, Lp)

    def contrib(panel_vals, panel_cols, panel_trow, panel_tcol, panel_tval,
                panel_sq, v):
        m_panel, Lp = panel_vals.shape
        if m_panel % bn != 0:
            raise ValueError(f"panel side {m_panel} must divide by bn={bn}")
        nJ = m_panel // bn
        has_panel_tail = int(panel_tval.shape[0]) > 0
        v = v.astype(dtype)

        def j_step(acc, jidx):
            j0 = jidx * bn
            valsJ = jax.lax.dynamic_slice(panel_vals, (j0, 0), (bn, Lp))
            colsJ = jax.lax.dynamic_slice(panel_cols, (j0, 0), (bn, Lp))
            # scatter-densify the J panel transposed: XJdT[col, j] += val
            XJdT = jnp.zeros((f, bn), dtype).at[colsJ, row_in_bn].add(valsJ)
            if has_panel_tail:
                in_j = jnp.logical_and(panel_trow >= j0, panel_trow < j0 + bn)
                jloc = jnp.clip(panel_trow - j0, 0, bn - 1)
                XJdT = XJdT.at[panel_tcol, jloc].add(
                    jnp.where(in_j, panel_tval, 0.0))
            vJ = jax.lax.dynamic_slice(v, (j0,), (bn,))
            sqJ = jax.lax.dynamic_slice(panel_sq, (j0,), (bn,))

            if has_row_tail:
                # I-side tail: G[r, :] += val_e * XJdT[col_e, :] for
                # every tail entry e of row r
                G_tail = jax.ops.segment_sum(
                    row_tval[:, None] * XJdT[row_tcol], row_trow,
                    num_segments=n_rows,
                ).reshape(nI, bm, bn)
            else:
                G_tail = jnp.zeros((nI, 1, 1), dtype)  # broadcast no-op

            def i_fn(args):
                vals_i, cols_i, sq_i, tail_i = args
                gath = XJdT[cols_i]  # (bm, L, bn) vectorized gather
                G = jnp.einsum("ml,mlb->mb", vals_i, gath) + tail_i
                K = _transform_block(kernel_int, G, sq_i, sqJ, degree,
                                     gamma, coef0)
                return K @ vJ  # (bm,)

            out = jax.lax.map(i_fn, (Vb, Cb, sqb, G_tail)).reshape(n_rows)
            return acc + out, None

        acc0 = jnp.zeros((n_rows,), dtype)
        Kv, _ = jax.lax.scan(j_step, acc0, jnp.arange(nJ))
        return Kv

    return contrib


#: widest feature count for which the blockwise device Gram assembly is used;
#: beyond it a (row_block, f) dense block stops being cheap and the host
#: SpGEMM wins (news20-scale data).
DEVICE_GRAM_MAX_FEATURES = 65536


def device_gram_max_features() -> int:
    """Env-overridable feature-width cutoff for the device Gram path."""
    try:
        return int(os.environ.get(
            "PLSSVM_DEVICE_GRAM_MAX_FEATURES", DEVICE_GRAM_MAX_FEATURES))
    except ValueError:
        return DEVICE_GRAM_MAX_FEATURES
