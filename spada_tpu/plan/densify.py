"""Plan-time structure-aware tile densification.

The tile engines' performance ceiling is set by how densely nonzeros pack
into tiles: a band straddling the tile grid or hub columns scattered
across k-tiles inflate both the padded tile FLOPs and the HBM tile bytes.
The reference adapts its *block shapes* to structure cycle-by-cycle
(scheduler.rs:296-379, rowwise/colwise adjust schemes); the counterpart
implemented here adapts the *layout* at plan time, before any
tile is cut:

- **k-grid anchor** (`choose_k_anchor`): scan a shift of the contraction
  grid — columns of A and rows of B move together, so C is *bit-identical*
  (a shifted tiling of the same products).  A band displaced off the
  diagonal (stencils with off-diagonal coupling) goes from straddling 2-3
  k-tiles per row panel back to the aligned minimum: measured on
  banded_offset(n=64k, band=384, offset=192) at T=384 the work list drops
  2708 -> 1528 items (1.77x fewer tile products and tile loads).
- **k permutation** (`degree_perm`): cluster heavy columns of A (= heavy
  rows of B) so scattered hub structure lands in few dense k-tiles.
  C = (A Q)(Q^T B) is exact for any permutation Q, so no extraction fixup
  is needed.  Measured on R-MAT(n=16k, deg 16) at T=256: W 202911 -> 138820.
- **row permutation**: cluster heavy rows of A (the reference's
  `sort_by_length` preprocessing, preprocessing.rs:76-89, applied for tile
  density rather than load balance).  Permutes C's rows; the plan carries
  the inverse and :func:`spada_tpu.ops.spgemm.spgemm` undoes it at
  extraction (the reference restores original row ids the same way,
  simulator.rs:1034-1062).  R-MAT T=256: W 138820 -> 90852 (2.2x total).

All candidates — including identity — are scored by the same closed-form
model (work items x per-item engine cost + unique tile bytes / HBM BW), so
structure that is already optimally laid out (the localized-powerlaw
community pattern, aligned bands) keeps its natural order: measured W
changes on those are within noise and the identity candidate wins.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from spada_tpu.config import SpadaConfig
from spada_tpu.platform import MODEL_TARGET
from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class DensifyPlan:
    """Chosen layout transform + its modeled cost.

    ``k_anchor``: columns of A / rows of B shift by this many scalars
    (implemented as zero-padding, exact).  ``k_perm``: permutation applied
    to A's columns and B's rows (``new_index = k_perm[old]``), or None.
    ``row_perm``: permutation of A's rows (``new_row = row_perm[old]``), or
    None; carried to extraction for the inverse.
    """

    k_anchor: int = 0
    k_perm: Optional[np.ndarray] = None
    row_perm: Optional[np.ndarray] = None
    candidate: str = "identity"
    modeled: dict = dataclasses.field(default_factory=dict)

    @property
    def is_identity(self) -> bool:
        return (self.k_anchor == 0 and self.k_perm is None
                and self.row_perm is None)


def _tile_stats(a: CsrMatrix, b: CsrMatrix, tm: int, tk: int, tn: int,
                k_anchor: int = 0, k_perm=None, row_perm=None,
                w_cap: int = 200_000_000) -> Tuple[int, int, int]:
    """(n_a_tiles, n_b_tiles, W) for a candidate layout — O(nnz) host model.

    The symbolic join is counted, not materialized: W = sum over nonzero A
    tiles of the B-tile count in their k row.
    """
    ar = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    ac = a.indices.astype(np.int64)
    if row_perm is not None:
        ar = row_perm[ar]
    if k_perm is not None:
        ac = k_perm[ac]
    n_k_tiles = (a.shape[1] + k_anchor + tk - 1) // tk + 1
    akeys = np.unique((ar // tm) * n_k_tiles + (ac + k_anchor) // tk)

    br = np.repeat(np.arange(b.shape[0]), np.diff(b.indptr))
    if k_perm is not None:
        br = k_perm[br]
    bc = b.indices.astype(np.int64)
    n_n_tiles = (b.shape[1] + tn - 1) // tn
    bkeys = np.unique(((br + k_anchor) // tk) * n_n_tiles + bc // tn)

    b_per_k = np.bincount(bkeys // n_n_tiles, minlength=n_k_tiles)
    W = int(b_per_k[akeys % n_k_tiles].sum())
    return len(akeys), len(bkeys), min(W, w_cap)


def _modeled_time(nA: int, nB: int, W: int, tm: int, tk: int, tn: int,
                  config: SpadaConfig, itemsize: int = 2) -> float:
    """Engine time model on the modelled target device: the larger of the
    unique-tile HBM traffic and the tile FLOPs at the kernel's fitted
    share of peak (the form of ``choose_tile_size``).  Its C-tile term is
    left out: the k transforms leave C's tiles unchanged."""
    peaks = MODEL_TARGET
    bytes_min = (nA * tm * tk + nB * tk * tn) * itemsize
    return max(bytes_min / peaks.hbm_bytes_per_s,
               2 * W * tm * tk * tn / (config.engine_flops_share
                                       * peaks.flops(itemsize)))


def degree_perm(weight: np.ndarray) -> np.ndarray:
    """Permutation clustering indices by descending weight:
    ``perm[old_index] = new_index``."""
    order = np.argsort(-weight, kind="stable")
    perm = np.empty(len(order), dtype=np.int64)
    perm[order] = np.arange(len(order))
    return perm


def choose_densify(a: CsrMatrix, b: CsrMatrix, tm: int, tk: int, tn: int,
                   config: Optional[SpadaConfig] = None,
                   anchors: Optional[Tuple[int, ...]] = None,
                   allow_row_perm: bool = True) -> DensifyPlan:
    """Score layout candidates and return the cheapest (identity included).

    Candidates: k-anchor scan (identity order), degree-clustered k, degree-
    clustered k + rows.  The anchor scan only applies to the identity
    order — a permuted axis has no grid alignment to recover.
    ``allow_row_perm=False`` restricts to transforms that leave C
    bit-identical (k-anchor, k-perm: C = (A Q)(Q^T B)), for callers that
    cannot carry an extraction-time row inverse.
    """
    config = config or SpadaConfig()
    if anchors is None:
        anchors = (0, tk // 4, tk // 2, 3 * tk // 4)
    itemsize = 2 if config.engine_dtype == "bfloat16" else 4

    cands = []  # (time, name, plan)
    for s in anchors:
        nA, nB, W = _tile_stats(a, b, tm, tk, tn, k_anchor=s)
        t = _modeled_time(nA, nB, W, tm, tk, tn, config, itemsize)
        cands.append((t, f"anchor{s}", DensifyPlan(
            k_anchor=s, candidate=f"anchor{s}",
            modeled={"n_a_tiles": nA, "n_b_tiles": nB, "w": W, "t_est": t})))

    acol = np.bincount(a.indices, minlength=a.shape[1]).astype(np.int64)
    blen = np.diff(b.indptr).astype(np.int64)
    kp = degree_perm(acol + blen)
    nA, nB, W = _tile_stats(a, b, tm, tk, tn, k_perm=kp)
    t = _modeled_time(nA, nB, W, tm, tk, tn, config, itemsize)
    cands.append((t, "ksort", DensifyPlan(
        k_perm=kp, candidate="ksort",
        modeled={"n_a_tiles": nA, "n_b_tiles": nB, "w": W, "t_est": t})))

    if allow_row_perm:
        rp = degree_perm(np.diff(a.indptr).astype(np.int64))
        nA, nB, W = _tile_stats(a, b, tm, tk, tn, k_perm=kp, row_perm=rp)
        t = _modeled_time(nA, nB, W, tm, tk, tn, config, itemsize)
        cands.append((t, "ksort+rowsort", DensifyPlan(
            k_perm=kp, row_perm=rp, candidate="ksort+rowsort",
            modeled={"n_a_tiles": nA, "n_b_tiles": nB, "w": W,
                     "t_est": t})))

    cands.sort(key=lambda c: c[0])
    best = cands[0][2]
    best.modeled["all"] = {name: round(t * 1e3, 4) for t, name, _ in cands}
    # prefer the identity when the win is inside model noise (<3%): layout
    # transforms cost a host pass and identity keeps natural row order
    ident_t = next(t for t, name, _ in cands if name == "anchor0")
    if cands[0][0] > 0.97 * ident_t and best.candidate != "anchor0":
        best = next(p for t, name, p in cands if name == "anchor0")
        best.modeled["all"] = {name: round(t * 1e3, 4)
                               for t, name, _ in cands}
    return best


def apply_densify(a: CsrMatrix, b: CsrMatrix,
                  plan: DensifyPlan) -> Tuple[CsrMatrix, CsrMatrix]:
    """Transform (A, B) per the plan; the product is exact up to the row
    permutation carried in ``plan.row_perm`` (C' = P_row C)."""
    if plan.is_identity:
        return a, b
    a2, b2 = a, b
    if plan.k_perm is not None:
        a2 = _permute_cols(a2, plan.k_perm)
        b2 = _permute_rows_full(b2, plan.k_perm)
    if plan.row_perm is not None:
        a2 = _permute_rows_full(a2, plan.row_perm)
    if plan.k_anchor:
        a2 = _shift_cols(a2, plan.k_anchor)
        b2 = _prepend_rows(b2, plan.k_anchor)
    return a2, b2


def invert_rows(plan: DensifyPlan, c: CsrMatrix) -> CsrMatrix:
    """Undo the row permutation on the extracted product.

    ``row_perm[old] = new`` means C'[new] = C[old]; ``reorder_rows(sel)``
    builds result[i] = c[sel[i]], so sel = row_perm restores original ids.
    """
    if plan.row_perm is None:
        return c
    return c.reorder_rows(plan.row_perm)


def _permute_cols(m: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """new_col = perm[old_col]; rows re-sorted by column."""
    indices = perm[m.indices]
    indptr = m.indptr
    data = m.data
    # sort within each row
    order = np.lexsort((indices,
                        np.repeat(np.arange(m.shape[0]), np.diff(indptr))))
    return CsrMatrix(m.shape, indptr.copy(), indices[order].astype(np.int32),
                     np.asarray(data)[order])


def _permute_rows_full(m: CsrMatrix, perm: np.ndarray) -> CsrMatrix:
    """new_row = perm[old_row] (full-length permutation)."""
    # reorder_rows takes sel[new] = old; build it from perm[old] = new
    sel = np.empty(m.shape[0], dtype=np.int64)
    sel[perm] = np.arange(m.shape[0])
    return m.reorder_rows(sel)


def _shift_cols(m: CsrMatrix, s: int) -> CsrMatrix:
    return CsrMatrix((m.shape[0], m.shape[1] + s), m.indptr.copy(),
                     (m.indices.astype(np.int64) + s).astype(np.int64),
                     np.asarray(m.data).copy())


def _prepend_rows(m: CsrMatrix, s: int) -> CsrMatrix:
    indptr = np.concatenate([np.zeros(s, m.indptr.dtype), m.indptr])
    return CsrMatrix((m.shape[0] + s, m.shape[1]), indptr,
                     m.indices.copy(), np.asarray(m.data).copy())
