"""The adaptive planner: row groups -> per-group panel heights -> execution.

This is the re-realization of the Spada adaptive scheduler: where
the simulator adjusts block shapes *during* execution from per-block feedback
(scheduler.rs:667-727 dispatching to the four adjust schemes), the planner
makes the same decision *before* jit execution so the device graph stays
static:

- ``scheme='analytic'`` (default): sweep every candidate panel height per row
  group through the exact tile-engine byte model
  (:func:`spada_tpu.plan.estimator.panel_cost_model`) and commit the argmin —
  the closed-form equivalent of scheme 0's sample-then-commit.
- ``scheme='profiled'``: measure actual kernel latency per candidate on a
  sampled prefix of each wide group (the scheme-3 signal,
  rowwise_perf_adjust.rs:121-231) and commit the argmin latency/element.

``execute_plan`` then runs one engine launch per distinct panel height
(static shapes per launch) and stitches the block-sparse results.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from spada_tpu.config import SpadaConfig
from spada_tpu.plan.estimator import BTileStructure, panel_cost_model
from spada_tpu.plan.groups import parse_group
from spada_tpu.platform import MODEL_TARGET
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class PanelSpec:
    row_start: int
    row_end: int
    tm: int


@dataclasses.dataclass
class ExecutionPlan:
    panels: List[PanelSpec]
    tile_k: int = 128
    tile_n: int = 128
    meta: dict = dataclasses.field(default_factory=dict)

    def tm_histogram(self) -> dict:
        h: dict = {}
        for p in self.panels:
            h[p.tm] = h.get(p.tm, 0) + (p.row_end - p.row_start)
        return h


def plan_spgemm(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    scheme: str = "analytic",
    measure: Optional[Callable[[int, int, int], float]] = None,
) -> ExecutionPlan:
    """Produce per-row-group panel heights.

    ``measure(row_start, row_end, tm) -> seconds`` enables profile-guided
    planning ('profiled'); required there, ignored for 'analytic'.
    """
    config = config or SpadaConfig()
    groups = parse_group(a.row_lens(), config.var_factor)
    bt = BTileStructure(b, config.tile_k, config.tile_n)
    itemsize = 2 if config.engine_dtype == "bfloat16" else 4

    def span_cost(s: int, e: int, tm: int) -> float:
        if scheme == "profiled" and measure is not None:
            # sample a prefix of the span (sample_num panels' worth)
            span = min(e - s, config.sample_num * tm)
            return measure(s, s + span, tm) / max(span, 1) * (e - s)
        return panel_cost_model(a, s, e, tm, bt, itemsize=itemsize,
                                config=config)["cost"]

    def best_for(s: int, e: int):
        best_tm, best_cost, per_tm = config.default_tm, float("inf"), {}
        for tm in config.tm_choices:
            c = span_cost(s, e, tm)
            per_tm[tm] = c
            if c < best_cost:
                best_cost, best_tm = c, tm
        return best_tm, best_cost, per_tm

    panels: List[PanelSpec] = []
    costs: List[float] = []
    group_costs = []
    for gi in groups.groups:
        s, e = gi.row_range
        if a.get_ele_num(s, e) == 0:
            panels.append(PanelSpec(s, e, config.default_tm))
            costs.append(0.0)
            continue
        best_tm, best_cost, per_tm = best_for(s, e)
        group_costs.append(per_tm)
        panels.append(PanelSpec(s, e, best_tm))
        costs.append(best_cost)

    # Agglomerative coalescing: a group is at most one panel tall to the
    # per-group argmin above, so it cannot see that fusing neighbors into a
    # TALLER shared panel collapses duplicate k-tile fan-out (the global
    # W reduction behind big tiles).  This is the batch analog of the
    # reference's narrow-group neighbor comparison
    # (rowwise_adjust.rs:209-255): merge adjacent spans while the union
    # models faster than the parts.
    if scheme == "analytic":
        improved = True
        while improved and len(panels) > 1:
            improved = False
            out_p, out_c = [panels[0]], [costs[0]]
            for p, c in zip(panels[1:], costs[1:]):
                q, cq = out_p[-1], out_c[-1]
                if q.row_end == p.row_start:
                    u_tm, u_cost, _ = best_for(q.row_start, p.row_end)
                    if u_cost < (cq + c) * 0.98:
                        out_p[-1] = PanelSpec(q.row_start, p.row_end, u_tm)
                        out_c[-1] = u_cost
                        improved = True
                        continue
                out_p.append(p)
                out_c.append(c)
            panels, costs = out_p, out_c

        # Global uniform candidate: pairwise greedy merging can stall in a
        # local minimum while the single whole-matrix panel span (which
        # collapses ALL duplicate k-fanout across groups) models cheaper —
        # the planner must never do worse than its own uniform choice
        # (round-5: the mixed rmat plan carried 2x the work items of
        # uniform T and measured 1.4x slower)
        if len(panels) > 1 and a.shape[0] > 0:
            u_tm, u_cost, _ = best_for(0, a.shape[0])
            if u_cost < sum(costs):
                panels = [PanelSpec(0, a.shape[0], u_tm)]
                costs = [u_cost]

    # merge adjacent same-height groups into single panels
    merged: List[PanelSpec] = []
    for p in panels:
        if merged and merged[-1].tm == p.tm and merged[-1].row_end == p.row_start:
            merged[-1] = PanelSpec(merged[-1].row_start, p.row_end, p.tm)
        else:
            merged.append(p)
    return ExecutionPlan(
        merged, config.tile_k, config.tile_n,
        meta={"scheme": scheme, "n_groups": groups.n_groups,
              "group_costs": group_costs},
    )


def make_profiled_measure(a: CsrMatrix, b: CsrMatrix,
                          config: Optional[SpadaConfig] = None):
    """Default ``measure`` callback for ``plan_spgemm(scheme='profiled')``.

    Runs the engine on the sampled row span at the candidate panel height and
    returns wall seconds — the measured-latency feedback of the reference's
    scheme 3 (rowwise_perf_adjust.rs:121-231), collected per candidate before
    committing instead of during execution.
    """
    import time as _time

    from spada_tpu.ops.engine import run_worklist
    from spada_tpu.ops.worklist import build_worklist

    config = config or SpadaConfig()
    b_bsr = BsrMatrix.from_csr(b, config.tile_k, config.tile_n,
                               dtype=np.float32)

    def measure(row_start: int, row_end: int, tm: int) -> float:
        sub, _ = _slice_rows_padded(
            a, [PanelSpec(row_start, row_end, tm)], tm
        )
        a_bsr = BsrMatrix.from_csr(sub, tm, config.tile_k, dtype=np.float32)
        wl = build_worklist(a_bsr, b_bsr, order="row")
        if wl.n_items == 0:
            return 0.0
        # warm (compile), then time the steady call
        run_worklist(wl, a_bsr.tiles, b_bsr.tiles,
                     precision=config.precision, engine=config.engine)
        t0 = _time.perf_counter()
        np.asarray(run_worklist(wl, a_bsr.tiles, b_bsr.tiles,
                                precision=config.precision,
                                engine=config.engine))
        return _time.perf_counter() - t0

    return measure


# ----------------------------------------------------------------------------
# Plan execution
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class _Segment:
    tm: int
    result: object                 # SpGemmResult
    tile_row_to_global: np.ndarray  # int64 [n_local_tile_rows] -> global row base


@dataclasses.dataclass
class PlanResult:
    """Mixed-panel-height SpGEMM result (same surface as SpGemmResult)."""

    shape: tuple
    segments: List[_Segment]
    n_work_items: int = 0
    mxu_flops: int = 0
    useful_flops: int = 0
    elapsed_s: Optional[float] = None
    # launch state retained for measure_device_perf reuse (one plan, one
    # BSR/worklist build per CLI run)
    host_state: Optional[dict] = None

    def todense(self) -> np.ndarray:
        d = np.zeros(self.shape, np.float32)
        for seg in self.segments:
            tiles = np.asarray(seg.result.c_tiles)
            tn = seg.result.tn
            for t in range(tiles.shape[0]):
                g0 = int(seg.tile_row_to_global[seg.result.c_tile_row[t]])
                c0 = int(seg.result.c_tile_col[t]) * tn
                h = min(seg.tm, self.shape[0] - g0)
                w = min(tn, self.shape[1] - c0)
                if h > 0 and w > 0:
                    # += not =: a panel's last tile pads past the panel end
                    # into rows owned by another segment; padded rows are
                    # exactly zero, so accumulation composes segments safely
                    d[g0 : g0 + h, c0 : c0 + w] += tiles[t, :h, :w]
        return d

    def to_csr(self) -> CsrMatrix:
        rows_all, cols_all, vals_all = [], [], []
        for seg in self.segments:
            tiles = np.asarray(seg.result.c_tiles)
            t, r, c = np.nonzero(tiles)
            rows = seg.tile_row_to_global[seg.result.c_tile_row[t]] + r
            cols = seg.result.c_tile_col[t].astype(np.int64) * seg.result.tn + c
            keep = (rows < self.shape[0]) & (cols < self.shape[1])
            rows_all.append(rows[keep])
            cols_all.append(cols[keep])
            vals_all.append(tiles[t, r, c][keep])
        if rows_all:
            return CsrMatrix.from_coo(
                self.shape,
                np.concatenate(rows_all),
                np.concatenate(cols_all),
                np.concatenate(vals_all),
            )
        return CsrMatrix(self.shape, np.zeros(self.shape[0] + 1, np.int64), [], [])


def _slice_rows_padded(a: CsrMatrix, panels: List[PanelSpec], tm: int):
    """Stack the rows of all panels with this tm into one CSR, each panel
    padded with empty rows to a multiple of tm.  Returns (csr, tile_row_base)
    where tile_row_base[i] is the global row of local tile-row i."""
    lens = a.row_lens()
    seg_lens, seg_idx, bases = [], [], []
    for p in panels:
        n_rows = p.row_end - p.row_start
        n_tiles = -(-n_rows // tm)
        pad = n_tiles * tm - n_rows
        seg_lens.append(lens[p.row_start : p.row_end])
        if pad:
            seg_lens.append(np.zeros(pad, np.int64))
        seg_idx.append(
            np.arange(a.indptr[p.row_start], a.indptr[p.row_end], dtype=np.int64)
        )
        bases.extend(p.row_start + tm * np.arange(n_tiles))
    lens_local = np.concatenate(seg_lens) if seg_lens else np.zeros(0, np.int64)
    idx = np.concatenate(seg_idx) if seg_idx else np.zeros(0, np.int64)
    indptr = np.zeros(len(lens_local) + 1, np.int64)
    indptr[1:] = np.cumsum(lens_local)
    sub = CsrMatrix(
        (len(lens_local), a.shape[1]), indptr, a.indices[idx], a.data[idx]
    )
    return sub, np.asarray(bases, dtype=np.int64)


def iter_plan_segments(a: CsrMatrix, b_bsr: BsrMatrix, plan: ExecutionPlan,
                       dtype):
    """Yield (tm, panels, bases, a_bsr, worklist) per panel-height group —
    the single source of the plan's launch decomposition, shared by
    :func:`execute_plan` and the device-timing mirror
    (ops.spgemm.measure_device_perf) so they can never drift apart."""
    from spada_tpu.ops.worklist import build_worklist

    by_tm = {}
    for p in plan.panels:
        by_tm.setdefault(p.tm, []).append(p)
    for tm, panels in sorted(by_tm.items()):
        sub, bases = _slice_rows_padded(a, panels, tm)
        if sub.nnz == 0:
            continue
        a_bsr = BsrMatrix.from_csr(sub, tm, plan.tile_k, dtype=dtype)
        wl = build_worklist(a_bsr, b_bsr, order="row")
        if wl.n_items == 0:
            continue
        yield tm, panels, bases, a_bsr, wl


def execute_plan(
    a: CsrMatrix, b: CsrMatrix, plan: ExecutionPlan, config: Optional[SpadaConfig] = None
) -> PlanResult:
    from spada_tpu.ops.engine import run_worklist
    from spada_tpu.ops.spgemm import _count_useful_flops

    config = config or SpadaConfig()
    engine = config.engine
    dtype = np.float32
    if config.engine_dtype == "bfloat16":
        import jax.numpy as jnp

        dtype = jnp.bfloat16

    b_bsr = BsrMatrix.from_csr(b, plan.tile_k, plan.tile_n, dtype=dtype)

    from spada_tpu.utils import trace

    segments = []
    host_segs = []
    n_work = 0
    mxu = 0
    t0 = time.perf_counter()
    for tm, panels, bases, a_bsr, wl in iter_plan_segments(
        a, b_bsr, plan, dtype
    ):
        host_segs.append((wl, a_bsr.tiles, b_bsr.tiles, tm))
        t_seg = time.perf_counter()
        c_tiles = run_worklist(
            wl, a_bsr.tiles, b_bsr.tiles, precision=config.precision,
            engine=engine,
        )
        # per-segment cost attribution — the adaptive feedback signal
        # (simulator.rs:589-603 block latency accounting)
        trace.emit(
            "segment", tm=tm, n_panels=len(panels), work_items=wl.n_items,
            c_tiles=wl.n_c_tiles, dur_s=time.perf_counter() - t_seg,
        )
        from spada_tpu.ops.spgemm import SpGemmResult

        res = SpGemmResult(
            shape=(a_bsr.shape[0], b.shape[1]), tm=tm, tn=plan.tile_n,
            c_tiles=np.asarray(c_tiles), c_tile_row=wl.c_tile_row,
            c_tile_col=wl.c_tile_col, tk=plan.tile_k,
            tile_itemsize=int(np.dtype(dtype).itemsize),
            n_work_items=wl.n_items,
        )
        segments.append(_Segment(tm, res, bases))
        n_work += wl.n_items
        mxu += 2 * wl.n_items * tm * plan.tile_k * plan.tile_n
    elapsed = time.perf_counter() - t0

    return PlanResult(
        shape=(a.shape[0], b.shape[1]),
        segments=segments,
        n_work_items=n_work,
        mxu_flops=mxu,
        useful_flops=_count_useful_flops(a, b),
        elapsed_s=elapsed,
        host_state={"segments": host_segs, "tk": plan.tile_k,
                    "tn": plan.tile_n},
    )


# ----------------------------------------------------------------------------
# Matrix-level tile-size selection
# ----------------------------------------------------------------------------

def _c_tile_count(a_rows, a_cols, b_rows, b_cols, n_i: int, n_k: int,
                  n_j: int) -> int:
    """Exact number of nonzero C tiles: the tile-level pattern product."""
    import scipy.sparse as sp

    pa = sp.csr_matrix((np.ones(len(a_rows)), (a_rows, a_cols)),
                       shape=(n_i, n_k))
    pb = sp.csr_matrix((np.ones(len(b_rows)), (b_rows, b_cols)),
                       shape=(n_k, n_j))
    return int((pa @ pb).nnz)


def choose_tile_size(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    candidates=(128, 256, 384, 512),
):
    """Pick the tile edge T for this matrix pair.

    The reference adapts block shapes to sparsity structure cycle-by-cycle;
    the matrix-level counterpart here is the tile granularity: bigger tiles
    amortize the per-work-item cost but pay padding bytes/FLOPs on sparse
    structure.  Cost model, for the modelled target device
    (:data:`spada_tpu.platform.MODEL_TARGET`, so a plan is the same on the
    CPU and on the card):

        t(T) = max(unique_bytes(T) / BW,  flops(T) / (share * peak))
               + nC(T) * T^2 * c_elem

    where unique_bytes counts each distinct nonzero A/B tile once plus the
    C writeback, flops = 2 W T^3, nC is the exact C-tile count (the
    tile-level pattern product), and share / c_elem are the kernel's fitted
    constants (config.engine_flops_share, config.engine_c_elem_s).

    Returns (T, details dict).
    """
    from spada_tpu.sparse.bsr import tiles_of_csr

    config = config or SpadaConfig()
    peaks = MODEL_TARGET
    details = {}
    best_t, best_cost = candidates[0], float("inf")
    itemsize = 2 if config.engine_dtype == "bfloat16" else 4
    for T in candidates:
        a_rows, a_cols, _ = tiles_of_csr(a, T, T)
        b_rows_t, b_cols_t, _ = tiles_of_csr(b, T, T)
        n_k = -(-b.shape[0] // T)
        b_fan = np.bincount(b_rows_t, minlength=n_k)
        W = int(b_fan[a_cols].sum())
        # count only tiles the worklist actually touches: A tiles whose k
        # has B fanout, and B tiles in k-rows some A tile reaches
        n_a = int((b_fan[a_cols] > 0).sum())
        n_b = int(b_fan[np.unique(a_cols)].sum())
        n_c = _c_tile_count(a_rows, a_cols, b_rows_t, b_cols_t,
                            -(-a.shape[0] // T), n_k, -(-b.shape[1] // T))
        unique_bytes = (n_a + n_b) * T * T * itemsize + n_c * T * T * 4
        flops = 2 * W * T ** 3
        t = (max(unique_bytes / peaks.hbm_bytes_per_s,
                 flops / (config.engine_flops_share
                          * peaks.flops(itemsize, config.precision)))
             + n_c * T * T * config.engine_c_elem_s)
        details[T] = {"W": W, "n_c": n_c, "bytes": unique_bytes,
                      "t_est": t}
        if t < best_cost:
            best_cost, best_t = t, T
    return best_t, details


# ----------------------------------------------------------------------------
# Column-window planning for the outer-product dataflow (schemes 1/2)
# ----------------------------------------------------------------------------

def plan_op_dataflow(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    scheme: Optional[int] = None,
    max_anchors: int = 512,
):
    """Drive the ``op`` dataflow's A-panel height with the colwise policies.

    The reference's column-wise schemes hill-climb block/window heights
    against the blocks to the LEFT while marching k-major
    (colwise_reg_adjust.rs:47-109, colwise_irr_adjust.rs:47-110).  Here
    the same policy objects, fed the closed-form traffic cost of each
    visited (row-band, k-block) anchor, commit per-anchor heights ahead of
    jit; the modal committed height (element-weighted), scaled by an
    8-row granule, becomes the op engine's panel height ``tm``.  This replaces the former
    hard-coded ``tm=8`` so schemes 1/2 decide something real.

    Returns ``(tm, details)``.
    """
    from spada_tpu.plan.policy import (BlockFeedback, ColwiseIrrPolicy,
                                       ColwiseRegPolicy, traffic_cost)
    from spada_tpu.plan.topo import BlockTopoTracker

    config = config or SpadaConfig()
    if scheme is None:
        scheme = config.adjust_scheme if config.adjust_scheme in (1, 2) else 1
    bw = config.colwise_block_width
    n_rows = a.shape[0]
    b_row_lens = np.diff(b.indptr).astype(np.int64)
    topo = BlockTopoTracker()
    if scheme == 2:
        pol = ColwiseIrrPolicy(config.lane_num, config.group_diviser, bw)
    else:
        pol = ColwiseRegPolicy(config.lane_num, bw)

    def irr_height(row_s: int, anchor_col: int) -> int:
        # scheme 2 reads the group's remembered shape off-boundary; seed it
        # if this sampled traversal skipped the boundary anchor
        gid = row_s // pol.group_size
        if row_s % pol.group_size != 0 and gid not in pol.group_shape:
            pol.group_shape[gid] = (pol.lane_num, pol.block_width)
        h, w = pol.adjust_block_shape(row_s, anchor_col, n_rows, topo)
        # every anchor placed in topo must have a known shape (off-boundary
        # anchors reuse the group shape without committing one themselves)
        pol.block_shape[(row_s, anchor_col)] = (h, w)
        return h

    height_votes: dict = {}
    token = 0
    row_s = 0
    band_h = config.lane_num
    while row_s < n_rows and token < max_anchors:
        # march k-blocks left->right inside this row band
        lo, hi = a.indptr[row_s], a.indptr[min(row_s + band_h, n_rows)]
        cols = np.sort(a.indices[lo:hi])
        edges = np.searchsorted(cols, np.arange(0, a.shape[1] + bw, bw))
        next_h = band_h
        for bi, ci in enumerate(np.flatnonzero(np.diff(edges))):
            if token >= max_anchors:
                break
            anchor_col = int(ci) * bw
            if scheme == 2:
                h = irr_height(row_s, anchor_col)
                if bi == 0:
                    next_h = h
            else:
                blk_h, _ = pol.adjust_block_shape(row_s, n_rows)
                h, _ = pol.adjust_window_shape(
                    token, row_s, anchor_col, blk_h, topo)
            seg = cols[edges[ci]:edges[ci + 1]]
            a_ele = len(seg)
            b_words = int(2 * b_row_lens[seg].sum())
            cost = traffic_cost(b_words, 0, 2 * b_words + 2 * a_ele,
                                config.cost_miss_weight)
            pol.block_info[token] = BlockFeedback(a_ele_num=a_ele, cost=cost)
            topo.add_block(token, row_s, anchor_col)
            height_votes[h] = height_votes.get(h, 0) + a_ele
            token += 1
        row_s += band_h
        band_h = max(1, next_h)
    if not height_votes:
        return 8, {"scheme": scheme, "anchors": 0, "heights": {}}
    mode_h = max(height_votes.items(), key=lambda kv: kv[1])[0]
    # scale lane-granular heights to 8-row-granular tile panels
    tm = 1 << int(np.clip(np.round(np.log2(max(mode_h, 1) * 8)), 3, 7))
    return tm, {"scheme": scheme, "anchors": token,
                "heights": height_votes, "mode_h": mode_h}
