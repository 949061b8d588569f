"""Element-granular SpGEMM path for scattered (hyper-sparse) structure.

This realizes the reference's element-level multiply-merge datapath — the
PE pipeline that multiplies A scalars against streamed B-row elements and
coalesces equal output columns through a SortingNetwork and MergeTree
(simulator.rs:117-235), plus the adder-tree psum merge
(adder_tree.rs:145-171).  The dense-tile engines (ops/engine.py) realize the
same semantics as tile products, which is right for clustered structure;
on scattered sparsity (SuiteSparse graphs, uniform-column power laws) tiles
are nearly empty and the tile join explodes (689k near-empty tile products
on a 16k loc-powerlaw matrix).  This module handles that regime.

Design: the symbolic phase runs on the host.  It plans the complete
expansion (every scalar product a[i,k]*b[k,j], the analog of the
scheduler's window expansion, scheduler.rs:482-606), sorts products by
output element, and lays the operand values out in padded, merge-aligned
buckets.  The device program then has no indexed operation at all: per
length class, a multiply and a fixed-width row sum, which XLA fuses into
one streaming pass over the operands.  The merge that the reference
performs in hardware (sorting-network + merge-tree) happens at plan time
as an argsort; the *numeric* work (every multiply, every accumulate)
happens on the device.  The host symbolic phase is the path's largest
cost end to end; expansion, sort and segmentation are sort-and-scan work
a GPU could do at memory speed, which is an open item (ROADMAP).

Layout: output elements (nonzeros of C) are bucketed by product-count class
L ∈ {1, 2, 4, ..., cap}; each bucket holds two [n, L] operand arrays (A
values and B values of the products that merge into each output element,
zero-padded).  Segments longer than ``cap`` split into several cap-wide
chunks whose partial sums share one CSR position (combined at extraction —
the psum-merge analog, scheduler.rs:381-480).  Bucket outputs concatenate in
"esc order"; ``esc_to_csr`` maps them to CSR data positions.

Like the BSR tile format, the ESC operand layout is a device format built
once per structure; refreshing values for the same structure is a pure host
re-gather (:func:`esc_operands`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class EscBucket:
    """Operand gather maps for all output chunks of one length class."""

    L: int                  # padded product count per output chunk
    a_gidx: np.ndarray      # [n, L] int32 into a.data (sentinel nnzA = 0.0)
    b_gidx: np.ndarray      # [n, L] int32 into b.data


@dataclasses.dataclass
class EscPlan:
    """Host-side symbolic phase result: C structure + operand layout maps.

    The structure half (indptr/indices) is the two-phase symbolic SpGEMM
    (SURVEY.md §7.3); the layout half replaces the reference's cycle-by-cycle
    fiber fetch (storage.rs:737-818) with a plan-time product arrangement.
    """

    shape: Tuple[int, int]
    indptr: np.ndarray          # [m+1] int64 — CSR structure of C
    indices: np.ndarray         # [nnzC] int32
    esc_to_csr: np.ndarray      # [n_chunks] int32: CSR position per chunk
    buckets: List[EscBucket]
    n_products: int             # exact scalar multiply count (E)
    n_padded: int               # padded product slots actually streamed

    @property
    def nnz_c(self) -> int:
        return int(len(self.indices))

    @property
    def density_efficiency(self) -> float:
        """Useful products / streamed product slots (padding overhead)."""
        return self.n_products / self.n_padded if self.n_padded else 1.0

    def operand_bytes(self, itemsize: int = 4, out_itemsize: int = 4) -> int:
        """HBM bytes one execution streams (operands + output)."""
        return (2 * self.n_padded * itemsize
                + len(self.esc_to_csr) * out_itemsize)


def _ceil_pow2(x: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (>=1) for positive ints."""
    x = np.maximum(x.astype(np.int64), 1)
    return (1 << np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


def build_esc_plan(a: CsrMatrix, b: CsrMatrix, cap: int = 512,
                   backend: str = "auto") -> EscPlan:
    """Symbolic phase: expand, sort (host), and bucket the product schedule.

    Pure structure — no values touched, so one plan serves any number of
    value refreshes (NN workloads with static sparsity).  ``backend``:
    'auto' prefers the C++ planner (native/spada_native.cpp esc_plan —
    single pass, per-row sort; the numpy path's global argsort plus
    fancy-indexed bucket fills are allocation-bound on this host);
    'python' forces the numpy reference implementation (parity-tested).
    """
    if backend == "auto":
        plan = _build_esc_plan_native(a, b, cap)
        if plan is not None:
            return plan
    return _build_esc_plan_numpy(a, b, cap)


def _build_esc_plan_native(a: CsrMatrix, b: CsrMatrix,
                           cap: int) -> Optional[EscPlan]:
    from spada_tpu import native

    m, n_cols = a.shape[0], b.shape[1]
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    E = expansion_products(a, b)
    if E == 0 or E >= 2**31 or cap & (cap - 1):
        return None
    out = native.esc_plan(a.indptr, a.indices, b.indptr, b.indices,
                          b.shape[0], cap, E)
    if out is None:
        return None
    counts, c_indices, c_row_counts, class_L, class_n, esc_to_csr, ag, bg = out
    nnz_c, total_chunks, n_padded, n_classes = (int(counts[0]),
                                                int(counts[1]),
                                                int(counts[2]),
                                                int(counts[3]))
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(c_row_counts[:m].astype(np.int64))
    buckets: List[EscBucket] = []
    base = 0
    for i in range(n_classes):
        L, n = int(class_L[i]), int(class_n[i])
        buckets.append(EscBucket(
            L,
            ag[base : base + n * L].reshape(n, L),
            bg[base : base + n * L].reshape(n, L),
        ))
        base += n * L
    return EscPlan((m, n_cols), indptr, c_indices[:nnz_c].copy(),
                   esc_to_csr[:total_chunks].copy(), buckets,
                   n_products=E, n_padded=n_padded)


def _build_esc_plan_numpy(a: CsrMatrix, b: CsrMatrix, cap: int) -> EscPlan:
    m, n_cols = a.shape[0], b.shape[1]
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    nnz_a, nnz_b = a.nnz, b.nnz
    b_lens = np.diff(b.indptr)
    fan = b_lens[a.indices]                       # products per A nonzero
    E = int(fan.sum())
    if E >= 2**31:
        # fail loudly: int32 gather indices overflow AND the host arrays
        # here are ~20 bytes/product (>40 GB) — this is not a slow path,
        # it is an out-of-range one.  spgemm_element slabs rows to stay
        # under the range automatically.
        raise ValueError(
            f"ESC plan expansion E={E} exceeds the single-plan range "
            f"(2^31 products); use spgemm_element, which streams row "
            f"slabs, or slab rows yourself")
    if E == 0:
        return EscPlan((m, n_cols), np.zeros(m + 1, np.int64),
                       np.zeros(0, np.int32), np.zeros(0, np.int32), [], 0, 0)
    # this numpy build's integer multiply is ~100x slower than float
    # (scalar fallback); float64 keys are exact below 2^53 and argsort them
    # just as well, so all big-array index arithmetic here stays in
    # float64 / int add-sub domain
    if float(m) * n_cols >= 2**53:
        raise ValueError("matrix too large for exact float64 merge keys")

    # --- expansion (the scheduler's window expansion, flattened) ---
    a_eidx = np.repeat(np.arange(nnz_a, dtype=np.int32), fan)
    ofs = np.cumsum(fan) - fan                    # int64 [nnzA]
    # b_eidx = b.indptr[a.indices][i] + (pos - ofs[i]) for expansion pos:
    # one small subtract, one repeat, one fast int64 add
    base = b.indptr[a.indices] - ofs              # int64 [nnzA]
    b_eidx = (np.repeat(base, fan)
              + np.arange(E, dtype=np.int64)).astype(np.int32)
    del base, ofs
    a_rows = np.repeat(
        np.arange(m, dtype=np.float64), np.diff(a.indptr)
    )[a_eidx]
    key = a_rows * float(n_cols) + b.indices[b_eidx]
    del a_rows

    # --- plan-time merge: sort products by output element ---
    # (the SortingNetwork of simulator.rs:117-176, resolved at plan time)
    perm = np.argsort(key, kind="stable")
    ks = key[perm]
    del key
    a_eidx, b_eidx = a_eidx[perm], b_eidx[perm]
    del perm
    newseg = np.empty(E, dtype=bool)
    newseg[0] = True
    np.not_equal(ks[1:], ks[:-1], out=newseg[1:])
    seg_starts = np.nonzero(newseg)[0]
    nnz_c = len(seg_starts)
    seg_len = np.diff(np.append(seg_starts, E))
    c_keys = ks[seg_starts]
    del ks, newseg
    c_rows = np.floor(c_keys / n_cols)
    indices = (c_keys - c_rows * n_cols).astype(np.int32)
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(
        c_rows.astype(np.int64), minlength=m
    ))

    # --- split oversized segments into cap-wide chunks ---
    # (cap is a power of two; shifts sidestep the slow integer mul/div)
    if cap & (cap - 1):
        raise ValueError("cap must be a power of two")
    log_cap = cap.bit_length() - 1
    n_chunks_per_seg = (seg_len + cap - 1) >> log_cap
    total_chunks = int(n_chunks_per_seg.sum())
    chunk_seg = np.repeat(
        np.arange(nnz_c, dtype=np.int64), n_chunks_per_seg
    )
    chunk_in_seg = (
        np.arange(total_chunks, dtype=np.int64)
        - np.repeat(np.cumsum(n_chunks_per_seg) - n_chunks_per_seg,
                    n_chunks_per_seg)
    )
    chunk_start = seg_starts[chunk_seg] + (chunk_in_seg << log_cap)
    chunk_len = np.minimum(
        seg_len[chunk_seg] - (chunk_in_seg << log_cap), cap
    )
    del chunk_in_seg, n_chunks_per_seg, seg_starts, seg_len

    # --- bucket chunks by power-of-two length class ---
    cls = _ceil_pow2(chunk_len)
    buckets: List[EscBucket] = []
    esc_parts: List[np.ndarray] = []
    n_padded = 0
    for L in np.unique(cls):
        L = int(L)
        mem = np.nonzero(cls == L)[0]
        starts_L = chunk_start[mem]
        lens_L = chunk_len[mem]
        lane = np.arange(L, dtype=np.int64)
        idx2 = starts_L[:, None] + lane[None, :]
        valid = lane[None, :] < lens_L[:, None]
        np.minimum(idx2, E - 1, out=idx2)
        ag = np.where(valid, a_eidx[idx2], nnz_a).astype(np.int32)
        bg = np.where(valid, b_eidx[idx2], nnz_b).astype(np.int32)
        del idx2, valid
        buckets.append(EscBucket(L, ag, bg))
        esc_parts.append(chunk_seg[mem].astype(np.int32))
        n_padded += len(mem) * L

    esc_to_csr = (np.concatenate(esc_parts) if esc_parts
                  else np.zeros(0, np.int32))
    return EscPlan((m, n_cols), indptr, indices, esc_to_csr, buckets,
                   n_products=E, n_padded=n_padded)


def esc_operands(plan: EscPlan, a: CsrMatrix, b: CsrMatrix,
                 dtype=np.float32) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Numeric layout: gather operand values into the plan's buckets.

    This is the per-value-refresh half: a pure host gather by the fixed
    plan indices (the analog of re-filling the fiber cache for new data).
    """
    a_ext = np.append(a.data, 0.0).astype(dtype)
    b_ext = np.append(b.data, 0.0).astype(dtype)
    # the L=1 class ships FLAT [n] (not [n,1]): its chunk values are the
    # products themselves, and an [n,1]->[n] reshape on device can be a
    # layout-changing copy that costs a full extra HBM pass
    return [(a_ext[bk.a_gidx[:, 0]], b_ext[bk.b_gidx[:, 0]]) if bk.L == 1
            else (a_ext[bk.a_gidx], b_ext[bk.b_gidx])
            for bk in plan.buckets]


def _esc_execute_jit(out_dtype=None):
    """Device numeric phase; ``out_dtype`` narrows the chunk-value store
    (bf16 halves the output write bytes); products and merges always
    accumulate in f32, matching the tile engines' f32 accumulation."""
    import jax
    import jax.numpy as jnp

    out_dtype = out_dtype or jnp.float32

    @jax.jit
    def run(operands):
        # returns a TUPLE of per-class chunk-value arrays (esc order =
        # bucket order): a device-side concatenate would re-stream the
        # whole output through HBM.  Consumers flatten on host via
        # esc_values_host / per-class offsets.
        outs = []
        for av, bv in operands:
            prod = (av * bv).astype(jnp.float32)
            if prod.ndim == 1:
                outs.append(prod.astype(out_dtype))
            elif prod.shape[1] == 1:
                # legacy [n,1] operands still work but pay a layout-copy
                # pass for the squeeze; esc_operands ships L=1 flat
                outs.append(prod.reshape(-1).astype(out_dtype))
            else:
                outs.append(jnp.sum(prod, axis=1).astype(out_dtype))
        return tuple(outs)

    return run


def esc_values_host(values) -> np.ndarray:
    """Flatten per-class device chunk values to one host array in esc
    (bucket-concatenated) order."""
    parts = [np.asarray(v) for v in values]
    return (np.concatenate(parts) if parts else np.zeros(0, np.float32))


_esc_runs: dict = {}           # out_dtype name -> jitted runner


def _esc_runner(out_dtype=None):
    """Cached jitted runner per output dtype (a bare module-global cache
    would silently ignore a different out_dtype on later calls)."""
    key = str(out_dtype)
    if key not in _esc_runs:
        _esc_runs[key] = _esc_execute_jit(out_dtype)
    return _esc_runs[key]


def esc_transfer(operands):
    """Move operand buckets to device (host->device, once per value set)."""
    import jax.numpy as jnp

    return tuple((jnp.asarray(av), jnp.asarray(bv)) for av, bv in operands)


def esc_execute(operands, out_dtype=None):
    """Device numeric phase: products + fixed-width merges, zero indexed ops.

    Returns the merged chunk values in esc order (device array).
    """
    return _esc_runner(out_dtype)(esc_transfer(operands))


@dataclasses.dataclass
class EscResult:
    """Element-path result: C structure (host) + chunk values (device)."""

    plan: EscPlan
    values: object    # tuple of per-class device arrays, esc (bucket) order
    elapsed_s: Optional[float] = None

    def to_csr(self) -> CsrMatrix:
        data = np.zeros(self.plan.nnz_c, np.float64)
        # oversized segments contributed several partial chunks at the same
        # CSR position; add-at combines them (the final psum merge); bf16
        # chunk values upcast first (ml_dtypes add.at support is spotty)
        np.add.at(data, self.plan.esc_to_csr,
                  esc_values_host(self.values).astype(np.float64))
        return CsrMatrix(self.plan.shape, self.plan.indptr,
                         self.plan.indices, data.astype(np.float32))

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()


@dataclasses.dataclass
class EscSlabbedResult:
    """Row-slab-streamed element result (nnz(C) and E beyond one plan).

    The analog of the reference's psum spill machinery
    (storage.rs:599-735) for the element path: rows are split so each
    slab's expansion fits the planner range and the host/device operand
    memory budget; slabs plan+execute independently (the ESC plan is
    per-row separable) and concatenate exactly.
    """

    shape: Tuple[int, int]
    parts: List[EscResult]
    elapsed_s: float

    @property
    def n_products(self) -> int:
        return sum(p.plan.n_products for p in self.parts)

    @property
    def n_padded(self) -> int:
        return sum(p.plan.n_padded for p in self.parts)

    @property
    def nnz_c(self) -> int:
        return sum(p.plan.nnz_c for p in self.parts)

    @property
    def n_chunks(self) -> int:
        return sum(len(p.plan.esc_to_csr) for p in self.parts)

    def operand_bytes(self, itemsize: int = 4, out_itemsize: int = 4) -> int:
        return sum(p.plan.operand_bytes(itemsize, out_itemsize)
                   for p in self.parts)

    def to_csr(self) -> CsrMatrix:
        return concat_row_slabs(self.shape,
                                [p.to_csr() for p in self.parts])

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()


def concat_row_slabs(shape, csrs) -> CsrMatrix:
    """Stack row-slab CSRs vertically into one matrix (exact: slabs
    partition the row space).  Shared by the slab-streamed and distributed
    element results."""
    if not csrs:
        return CsrMatrix(shape, np.zeros(shape[0] + 1, np.int64), [], [])
    offs = np.cumsum([0] + [c.nnz for c in csrs])[:-1]
    indptr = np.concatenate(
        [[0]] + [c.indptr[1:] + off for c, off in zip(csrs, offs)]
    ).astype(np.int64)
    return CsrMatrix(
        shape, indptr,
        np.concatenate([c.indices for c in csrs]),
        np.concatenate([c.data for c in csrs]),
    )


def _slice_rows(m: CsrMatrix, s: int, t: int) -> CsrMatrix:
    lo, hi = int(m.indptr[s]), int(m.indptr[t])
    return CsrMatrix((t - s, m.shape[1]), m.indptr[s : t + 1] - lo,
                     m.indices[lo:hi], m.data[lo:hi])


def _row_slab_bounds(a: CsrMatrix, b: CsrMatrix, max_products: int):
    """Row boundaries such that each slab's expansion <= max_products
    (a single row over the limit gets its own slab — its plan must still
    fit the 2^31 range or the planner raises loudly).  Vectorized: repeated
    searchsorted on the cumulative expansion instead of a per-row Python
    loop (the path only triggers for huge matrices)."""
    blen = np.diff(b.indptr).astype(np.int64)
    fan = blen[a.indices]
    cs = np.concatenate([[0], np.cumsum(fan)])
    row_e_cum = cs[a.indptr]          # [m+1] cumulative E at row starts
    bounds = [0]
    m = a.shape[0]
    while bounds[-1] < m:
        start = bounds[-1]
        # furthest row end whose slab expansion stays under the budget
        r = int(np.searchsorted(row_e_cum, row_e_cum[start] + max_products,
                                side="right")) - 1
        bounds.append(max(min(r, m), start + 1))
    return bounds


def spgemm_element(a: CsrMatrix, b: CsrMatrix, cap: int = 512,
                   plan: Optional[EscPlan] = None,
                   dtype=np.float32, max_slab_products: int = 2**28):
    """One-call element-granular SpGEMM (plan + operands + execute).

    ``elapsed_s`` times the device execution only (transfer is a one-time
    format cost, like shipping BSR tiles).  Expansions larger than
    ``max_slab_products`` (default 2^28 ≈ 2.1 GB of f32 operands) stream
    through row slabs and return an :class:`EscSlabbedResult`.  The
    numeric executor is XLA's fused multiply + row sum.
    """
    if (plan is None and a.shape[0] > 1
            and expansion_products(a, b) > max_slab_products):
        bounds = _row_slab_bounds(a, b, max_slab_products)
        parts = []
        elapsed = 0.0
        for s, t in zip(bounds[:-1], bounds[1:]):
            part = spgemm_element(_slice_rows(a, s, t), b, cap=cap,
                                  dtype=dtype,
                                  max_slab_products=max_slab_products)
            parts.append(part)
            elapsed += part.elapsed_s or 0.0
        return EscSlabbedResult((a.shape[0], b.shape[1]), parts, elapsed)
    plan = plan or build_esc_plan(a, b, cap=cap)
    import jax

    ops = esc_transfer(esc_operands(plan, a, b, dtype=dtype))
    run = _esc_runner()

    jax.block_until_ready(run(ops))  # compile + warm
    t0 = time.perf_counter()
    vals = run(ops)
    jax.block_until_ready(vals)
    return EscResult(plan, vals, elapsed_s=time.perf_counter() - t0)


def expansion_products(a: CsrMatrix, b: CsrMatrix) -> int:
    """Closed-form E = Σ_k nnz(A[:,k]) · nnz(B[k,:]) (cheap, pre-plan)."""
    acol = np.bincount(a.indices, minlength=a.shape[1]).astype(np.int64)
    return int(np.dot(acol, np.diff(b.indptr).astype(np.int64)))


def element_path_bytes(e_products: int, itemsize: int = 4) -> int:
    """Dispatch byte model: worst-case streamed bytes for E products.

    Padding ≤ 2x (pow-2 classes) and nnzC ≤ E give the bound; the true
    plan's ``operand_bytes`` is usually much lower.
    """
    return 2 * 2 * e_products * itemsize + e_products * 4
