"""Analytic cost / footprint estimators.

Two families:

1. **Expected-psum-size estimation** — the legacy traffic model's cache-fit
   heuristic (storage_traffic_model.rs:1140-1208 scheme 5): from B row-group
   average densities, estimate the merged output-row nnz of an A row as
   ``(1 - prod_g (1 - d_g)^{k_g}) * b_width`` and walk rows until the
   expected psum footprint overflows the budget.  The rebuild uses it to
   bound dense-accumulator row-panel heights against on-chip memory.

2. **Tile-engine byte model** — the planner's primary signal: for a candidate
   panel height, the exact HBM bytes the work-list engine will move
   (A tiles + B tiles per work item, C tiles once), normalized by useful
   FLOPs.  This replaces the simulator's measured per-block cost/latency
   feedback with a closed-form evaluation the host can sweep in one pass.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spada_tpu.plan.groups import GroupTracker
from spada_tpu.sparse.csr import CsrMatrix


def expected_merged_row_nnz(
    a_row_cols: np.ndarray, b_group: GroupTracker, b_width: int
) -> float:
    """Expected nnz of the merged psum row for one A row.

    ``a_row_cols``: the A row's column indices (= B row ids it touches).
    For each touched B group g with average row density d_g and k_g touches,
    a given output column stays zero with probability prod (1-d_g)^{k_g}.
    """
    if len(a_row_cols) == 0 or b_width == 0:
        return 0.0
    gids = b_group.rgmap[np.asarray(a_row_cols, dtype=np.int64)]
    uniq, counts = np.unique(gids, return_counts=True)
    log_zero_prob = 0.0
    for g, k in zip(uniq, counts):
        d = min(b_group.groups[int(g)].avg_row_len / b_width, 1.0 - 1e-12)
        log_zero_prob += float(k) * np.log1p(-d)
    return (1.0 - np.exp(log_zero_prob)) * b_width


def max_cachable_rows(
    a: CsrMatrix,
    row_start: int,
    b_group: GroupTracker,
    b_width: int,
    budget_words: int,
    max_rows: int,
) -> int:
    """How many consecutive A rows' expected psums fit in half the budget
    (the ``exp_psum_size * 2 > capability`` test, storage_traffic_model.rs:1184).

    Each merged psum element costs 2 words (index + value, as upstream)."""
    rows = 0
    exp_words = 0.0
    r = row_start
    while rows < max_rows and r < a.row_num:
        cols, _ = a.row(r)
        if len(cols):
            exp_words += 2.0 * expected_merged_row_nnz(cols, b_group, b_width)
            if exp_words * 2.0 > budget_words:
                break
        rows += 1
        r += 1
    return max(1, rows)


class BTileStructure:
    """Per-contraction-tile view of B's nonzero tile columns (tk x tn tiles)."""

    def __init__(self, b: CsrMatrix, tk: int = 128, tn: int = 128):
        self.tk, self.tn = tk, tn
        self.n_k_tiles = -(-b.shape[0] // tk)
        rows = np.repeat(np.arange(b.shape[0]), np.diff(b.indptr))
        ktile = rows // tk
        jtile = b.indices.astype(np.int64) // tn
        key = ktile * (-(-b.shape[1] // tn)) + jtile
        uniq = np.unique(key)
        self.n_tile_cols = -(-b.shape[1] // tn)
        self.tile_k = (uniq // self.n_tile_cols).astype(np.int64)
        self.tile_j = (uniq % self.n_tile_cols).astype(np.int64)
        self.rowptr = np.zeros(self.n_k_tiles + 1, dtype=np.int64)
        np.add.at(self.rowptr, self.tile_k + 1, 1)
        self.rowptr = np.cumsum(self.rowptr)

    def fanout(self, k_tiles: np.ndarray) -> np.ndarray:
        lens = np.diff(self.rowptr)
        return lens[k_tiles]

    def j_tiles_of(self, k: int) -> np.ndarray:
        return self.tile_j[self.rowptr[k] : self.rowptr[k + 1]]


def panel_cost_model(
    a: CsrMatrix,
    row_start: int,
    row_end: int,
    tm: int,
    bt: BTileStructure,
    itemsize: int = 4,
    config=None,
) -> Dict[str, float]:
    """Exact byte/flop model of the tile engine on rows [row_start, row_end)
    split into panels of height ``tm``.

    With ``config`` the returned ``cost`` is modeled SECONDS on the
    modelled target device, the same form as ``choose_tile_size``:
    ``max(bytes/BW, flops/(share*peak)) + C elements * c_elem``.  Without
    config, ``cost`` falls back to bytes (pure traffic argmin) — byte-only
    ranking systematically over-favors thin panels.

    Returns work items W, C tiles, HBM bytes, and tile flops."""
    tk, tn = bt.tk, bt.tn
    s, e = a.indptr[row_start], a.indptr[row_end]
    rows = np.repeat(
        np.arange(row_start, row_end), np.diff(a.indptr[row_start : row_end + 1])
    )
    cols = a.indices[s:e].astype(np.int64)
    if len(rows) == 0:
        return dict(work=0, c_tiles=0, bytes=0.0, mxu_flops=0, cost=0.0)
    panel = (rows - row_start) // tm
    ktile = cols // tk
    # distinct A tiles (panel, ktile)
    akey = panel * bt.n_k_tiles + ktile
    a_tiles = np.unique(akey)
    ap = a_tiles // bt.n_k_tiles
    ak = a_tiles % bt.n_k_tiles
    fan = bt.fanout(ak)
    W = int(fan.sum())
    # distinct C tiles per panel: union of j-tile sets over the panel's k's —
    # expand every (panel, k) to its j tiles (O(W)) and count unique (panel, j)
    if W:
        panel_rep = np.repeat(ap, fan)
        starts = bt.rowptr[ak]
        offs = np.arange(W) - np.repeat(np.cumsum(fan) - fan, fan)
        j_rep = bt.tile_j[np.repeat(starts, fan) + offs]
        c_tiles = len(np.unique(panel_rep * bt.n_tile_cols + j_rep))
    else:
        c_tiles = 0
    bytes_moved = (
        W * (tm * tk + tk * tn) * itemsize + c_tiles * tm * tn * itemsize
    )
    mxu_flops = 2 * W * tm * tk * tn
    if config is not None:
        from spada_tpu.platform import MODEL_TARGET

        # the C-tile term ADDS to the roofline bound (sum form), as in
        # choose_tile_size
        peak = (config.engine_flops_share
                * MODEL_TARGET.flops(itemsize, config.precision))
        cost = (max(bytes_moved / MODEL_TARGET.hbm_bytes_per_s,
                    mxu_flops / peak)
                + c_tiles * tm * tn * config.engine_c_elem_s)
    else:
        cost = float(bytes_moved)
    return dict(
        work=W, c_tiles=int(c_tiles), bytes=float(bytes_moved),
        mxu_flops=mxu_flops, cost=cost,
    )
