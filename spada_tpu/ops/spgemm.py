"""Public SpGEMM entry point: C = A @ B for sparse A, B.

The dataflow axis mirrors the reference accelerator enum
(``Ip | Op | MultiRow | Spada``, frontend.rs:36-41), re-realized as schedule
variants of the tile engine:

- ``'ip'``     inner-product / output-stationary: fixed 128-row panels,
               row-major schedule.
- ``'op'``     outer-product: k-major schedule with scatter-accumulated HBM
               psums (the reference's ``[lane_num, 1]`` column-window mode,
               main.rs:70).
- ``'rowwise'`` row-wise Gustavson with a fixed moderate panel height
               (the ``MultiRow`` accelerator).
- ``'spada'``  adaptive: per-row-group panel heights picked by the planner
               (plan/), the plan-time realization of the adaptive block
               shapes of rowwise_perf_adjust.rs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from spada_tpu.config import SpadaConfig
from spada_tpu.ops.engine import run_worklist
from spada_tpu.ops.worklist import WorkList, build_worklist
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class SpGemmResult:
    """Numeric result (block-sparse or element-granular) + execution metadata."""

    shape: tuple
    tm: int
    tn: int
    c_tiles: np.ndarray          # [nC, tm, tn] f32 (device or host array)
    c_tile_row: np.ndarray
    c_tile_col: np.ndarray
    tk: int = 128                # contraction tile edge used by the engine
    tile_itemsize: int = 4       # bytes/element of the A/B tiles as moved
    n_work_items: int = 0
    mxu_flops: int = 0           # tile FLOPs issued (padding included)
    useful_flops: int = 0        # 2 * scalar multiply count (the algorithmic work)
    elapsed_s: Optional[float] = None
    # element-granular (ESC) path result; when set, c_tiles is empty and
    # todense/to_csr delegate (see spada_tpu.ops.element)
    element: Optional[object] = None
    engine_used: str = "tile"    # 'tile' | 'element'
    # host-side launch state ({"segments": [(wl, a_tiles, b_tiles, tm)],
    # "tk", "tn"}) retained so measure_device_perf can time exactly the
    # launches this result ran without replanning
    host_state: Optional[dict] = None

    def todense(self) -> np.ndarray:
        if self.element is not None:
            return self.element.todense()
        tiles = np.asarray(self.c_tiles)
        n_tile_cols = -(-self.shape[1] // self.tn)
        n_tile_rows = -(-self.shape[0] // self.tm)
        d = np.zeros((n_tile_rows * self.tm, n_tile_cols * self.tn), np.float32)
        for t in range(tiles.shape[0]):
            r0 = int(self.c_tile_row[t]) * self.tm
            c0 = int(self.c_tile_col[t]) * self.tn
            d[r0 : r0 + self.tm, c0 : c0 + self.tn] = tiles[t]
        return d[: self.shape[0], : self.shape[1]]

    def to_csr(self, prune_eps: float = 0.0) -> CsrMatrix:
        """Extract CSR from the result (the rebuild's ``get_exec_result``,
        simulator.rs:1034-1062)."""
        if self.element is not None:
            return self.element.to_csr()
        tiles = np.asarray(self.c_tiles)
        t, r, c = np.nonzero(np.abs(tiles) > prune_eps)
        rows = self.c_tile_row[t].astype(np.int64) * self.tm + r
        cols = self.c_tile_col[t].astype(np.int64) * self.tn + c
        keep = (rows < self.shape[0]) & (cols < self.shape[1])
        return CsrMatrix.from_coo(
            self.shape, rows[keep], cols[keep], tiles[t, r, c][keep]
        )

    @property
    def nnz_tiles(self) -> int:
        return int(np.asarray(self.c_tiles).shape[0])


def _count_useful_flops(a: CsrMatrix, b: CsrMatrix) -> int:
    """2 * Σ_k nnz(A[:,k]) * nnz(B[k,:]) — the scalar multiply count."""
    a_col_counts = np.bincount(a.indices, minlength=a.shape[1])
    b_row_lens = np.diff(b.indptr)
    return int(2 * np.dot(a_col_counts.astype(np.int64), b_row_lens.astype(np.int64)))


def element_plan_bytes(a: CsrMatrix, b: CsrMatrix, cap: int = 512) -> dict:
    """Exact streamed bytes of the ESC plan WITHOUT building it.

    The chunk-length histogram is the per-C-nonzero product count — the
    boolean pattern product A_pat @ B_pat (scipy, O(E) in C).  Each count
    ``c`` streams ``(c // cap) * cap`` full-cap slots plus
    ``ceil_pow2(c % cap)`` for the remainder chunk, two f32 operands per
    slot, plus one f32 output per chunk — exactly
    :meth:`EscPlan.operand_bytes` of the plan the runner would build.
    """
    import scipy.sparse as sp

    from spada_tpu.ops.element import _ceil_pow2

    pa = sp.csr_matrix(
        (np.ones(a.nnz, np.float64), a.indices, a.indptr), shape=a.shape)
    pb = sp.csr_matrix(
        (np.ones(b.nnz, np.float64), b.indices, b.indptr), shape=b.shape)
    counts = (pa @ pb).data.astype(np.int64)
    full = counts // cap
    rem = counts % cap
    n_padded = int(full.sum()) * cap + int(_ceil_pow2(rem[rem > 0]).sum())
    n_chunks = int(full.sum()) + int((rem > 0).sum())
    return {"n_padded": n_padded, "n_chunks": n_chunks,
            "nnz_c": len(counts),
            "bytes": 2 * n_padded * 4 + n_chunks * 4}


def estimate_element_time(a: CsrMatrix, b: CsrMatrix,
                          config: SpadaConfig,
                          tile_t: Optional[float] = None) -> dict:
    """Time model for the element (ESC) path on the modelled target
    device, symmetric in fidelity with the tile side's calibrated model:
    streamed bytes at the executor's measured share of the HBM rate.

    Bounds first (padding is between 1x and 2x of E, pow-2 classes), then
    the EXACT plan bytes via the pattern-product chunk histogram
    (:func:`element_plan_bytes`) whenever the decision is ambiguous — i.e.
    ``tile_t`` falls between the bounds — or when no ``tile_t`` is given
    and E is small enough that the O(E) pattern product is cheap.
    """
    from spada_tpu.ops.element import expansion_products
    from spada_tpu.platform import MODEL_TARGET

    e = expansion_products(a, b)
    bw = config.element_bw_share * MODEL_TARGET.hbm_bytes_per_s
    overhead = 30e-6
    if e == 0:
        return {"e_products": 0, "t_est": overhead, "bytes_model": "exact"}
    t_lo = (2 * e * 4 + e * 4) / bw + overhead      # zero padding
    t_hi = (2 * 2 * e * 4 + e * 4) / bw + overhead  # 2x worst case
    ambiguous = (tile_t is not None and t_lo < tile_t < t_hi)
    if ambiguous or (tile_t is None and e < 2**28):
        pb = element_plan_bytes(a, b, cap=config.element_cap)
        return {"e_products": e,
                "t_est": pb["bytes"] / bw + overhead,
                "bytes_model": "exact", **pb}
    # decision identical at both bounds (or E too large to enumerate at
    # plan fidelity without paying the symbolic pass twice): worst case
    return {"e_products": e, "t_est": t_hi, "t_lo": t_lo,
            "bytes_model": "worst-case"}


def dispatch_dataflow(a: CsrMatrix, b: CsrMatrix,
                      config: SpadaConfig) -> Tuple[str, dict]:
    """Tile vs element engine choice by modeled time.

    The reference adapts its dataflow to sparsity structure cycle-by-cycle
    (scheduler.rs adjust schemes); the matrix-level analog is this
    density-regime dispatch: clustered structure -> tile products,
    scattered structure -> the streaming element path.  Both sides use
    plan-true byte models on the modelled target device (tile: unique tile
    bytes + per-item time; element: exact chunk-histogram bytes in the
    ambiguous band).
    """
    from spada_tpu.plan.planner import choose_tile_size

    t_best, t_det = choose_tile_size(a, b, config)
    t_tile = min(v["t_est"] for v in t_det.values())
    elem = estimate_element_time(a, b, config, tile_t=t_tile)
    choice = "element" if elem["t_est"] < t_tile else "tile"
    return choice, {"element": elem, "tile": t_det, "tile_T": t_best}


def _spgemm_via_element(a: CsrMatrix, b: CsrMatrix,
                        config: SpadaConfig) -> SpGemmResult:
    from spada_tpu.ops.element import spgemm_element

    er = spgemm_element(a, b, cap=config.element_cap)
    # plain or row-slab-streamed result (EscResult / EscSlabbedResult)
    n_padded = (er.plan.n_padded if hasattr(er, "plan") else er.n_padded)
    n_products = (er.plan.n_products if hasattr(er, "plan")
                  else er.n_products)
    n_chunks = (len(er.plan.esc_to_csr) if hasattr(er, "plan")
                else er.n_chunks)
    return SpGemmResult(
        shape=(a.shape[0], b.shape[1]), tm=1, tn=1,
        c_tiles=np.zeros((0, 1, 1), np.float32),
        c_tile_row=np.zeros(0, np.int32), c_tile_col=np.zeros(0, np.int32),
        n_work_items=n_chunks,
        mxu_flops=2 * n_padded,
        useful_flops=2 * n_products,
        elapsed_s=er.elapsed_s, element=er, engine_used="element",
    )


def spgemm(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    dataflow: Optional[str] = None,
    tm: Optional[int] = None,
    plan=None,
    dtype=np.float32,
) -> SpGemmResult:
    """Sparse-times-sparse matrix multiply on the default JAX device.

    For ``dataflow='spada'`` a planner-produced :class:`ExecutionPlan` may be
    passed (see spada_tpu.plan); otherwise a single uniform panel height is
    used.  ``dataflow='element'`` forces the element-granular ESC engine;
    under ``'spada'`` the engine is picked per matrix by
    :func:`dispatch_dataflow` (config.element_dispatch).
    """
    config = config or SpadaConfig()
    dataflow = dataflow or config.dataflow
    if dataflow not in ("spada", "ip", "op", "rowwise", "element"):
        raise ValueError(
            f"unknown dataflow {dataflow!r}; "
            "expected spada|ip|op|rowwise|element"
        )
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")

    if dataflow == "element" or (
        dataflow == "spada" and config.element_dispatch == "always"
    ):
        return _spgemm_via_element(a, b, config)
    if (dataflow == "spada" and plan is None
            and config.element_dispatch == "auto"):
        choice, _ = dispatch_dataflow(a, b, config)
        if choice == "element":
            return _spgemm_via_element(a, b, config)

    if dataflow == "spada" and plan is not None:
        from spada_tpu.plan.planner import execute_plan

        return execute_plan(a, b, plan, config)

    if tm is None:
        if dataflow == "op":
            # the colwise adjust schemes (1/2) pick the outer-product panel
            # height from structure, replacing the reference's fixed
            # [lane_num, 1] block (main.rs:70)
            from spada_tpu.plan.planner import plan_op_dataflow

            tm, _ = plan_op_dataflow(a, b, config)
        elif dataflow == "rowwise":
            tm = _multirow_tm(config)
        else:
            tm = {"ip": 128}.get(dataflow, config.default_tm)

    order = "k" if dataflow == "op" else "row"
    if dataflow == "spada" and config.densify == "auto":
        # C-invariant layout densification (k-anchor / k-perm only:
        # C = (A Q)(Q^T B) exactly, so no extraction fixup exists to carry)
        from spada_tpu.plan.densify import apply_densify, choose_densify

        dplan = choose_densify(a, b, tm, config.tile_k, config.tile_n,
                               config, allow_row_perm=False)
        if not dplan.is_identity:
            a, b = apply_densify(a, b, dplan)
    if dtype is np.float32 and config.engine_dtype == "bfloat16":
        import jax.numpy as jnp

        dtype = jnp.bfloat16
    a_bsr = BsrMatrix.from_csr(a, tm, config.tile_k, dtype=dtype)
    b_bsr = BsrMatrix.from_csr(b, config.tile_k, config.tile_n, dtype=dtype)
    wl = build_worklist(a_bsr, b_bsr, order=order)

    isz = int(np.dtype(dtype).itemsize)
    if wl.n_items == 0:
        return SpGemmResult(
            shape=(a.shape[0], b.shape[1]), tm=tm, tn=config.tile_n,
            c_tiles=np.zeros((0, tm, config.tile_n), np.float32),
            c_tile_row=wl.c_tile_row, c_tile_col=wl.c_tile_col,
            tk=config.tile_k, tile_itemsize=isz,
            useful_flops=0, mxu_flops=0,
        )

    t0 = time.perf_counter()
    c_tiles = run_worklist(
        wl, a_bsr.tiles, b_bsr.tiles, precision=config.precision,
        engine=config.engine,
    )
    c_tiles = np.asarray(c_tiles)  # block until done
    elapsed = time.perf_counter() - t0

    return SpGemmResult(
        shape=(a.shape[0], b.shape[1]), tm=tm, tn=config.tile_n,
        c_tiles=c_tiles, c_tile_row=wl.c_tile_row, c_tile_col=wl.c_tile_col,
        tk=config.tile_k, tile_itemsize=isz,
        n_work_items=wl.n_items,
        mxu_flops=2 * wl.n_items * tm * config.tile_k * config.tile_n,
        useful_flops=_count_useful_flops(a, b),
        elapsed_s=elapsed,
        host_state={"segments": [(wl, a_bsr.tiles, b_bsr.tiles, tm)],
                    "tk": config.tile_k, "tn": config.tile_n},
    )


def measure_device_perf(a: CsrMatrix, b: CsrMatrix,
                        config: Optional[SpadaConfig] = None,
                        dataflow: Optional[str] = None,
                        plan=None, host_state=None) -> Optional[dict]:
    """Device time of the launches :func:`spgemm` runs, on the GPU.

    The reference reports per-PE ``mult_util`` / ``active_cycle`` per run
    (simulator.rs:762-775, 1008-1032); this is the rebuild's analog
    measured on the card: engine seconds via
    :func:`spada_tpu.utils.timing.device_time` (tiles on the device to C on
    the device; upload and extraction excluded), achieved FLOP/s, and the
    modeled HBM bytes as a share of the peak of the device it ran on
    (:func:`spada_tpu.platform.device_peaks`).  Raises off the GPU.
    Returns None when there is nothing to time (empty product) or when the
    element product was too large for one plan (row-slab path).
    """
    import jax.numpy as jnp

    from spada_tpu.platform import device_peaks, require_gpu

    require_gpu("measure_device_perf")
    peaks = device_peaks()
    from spada_tpu.utils.timing import device_time

    config = config or SpadaConfig()
    dataflow = dataflow or config.dataflow

    # mirror spgemm()'s engine resolution: an auto-dispatched 'spada' run
    # may have executed the ELEMENT engine — timing the tile worklist then
    # would report an engine that never ran
    if (dataflow == "spada" and plan is None and host_state is None
            and config.element_dispatch in ("auto", "always")):
        if config.element_dispatch == "always":
            dataflow = "element"
        else:
            choice, _ = dispatch_dataflow(a, b, config)
            if choice == "element":
                dataflow = "element"

    if dataflow == "element":
        from spada_tpu.ops.element import (_esc_runner, build_esc_plan,
                                           esc_operands, esc_transfer,
                                           expansion_products)

        if a.shape[0] > 1 and expansion_products(a, b) > 2**28:
            # spgemm ran the row-slab path; one whole-matrix plan here
            # would allocate the very memory the slab path exists to avoid
            return None
        eplan = build_esc_plan(a, b, cap=config.element_cap)
        ops = esc_transfer(esc_operands(eplan, a, b))
        run = _esc_runner()
        bytes_model = eplan.operand_bytes()
        flat = [x for pair in ops for x in pair]
        if not flat:
            return None

        # operand perturbation is the timing harness's job (in-place on
        # carried buffers); a caller-side add costs a phantom HBM pass
        def fn(*xs):
            pairs = tuple((xs[2 * i], xs[2 * i + 1])
                          for i in range(len(xs) // 2))
            return run(pairs)

        el = device_time(fn, tuple(flat))
        return {
            "engine": "element-xla",
            "engine_s": el,
            "hbm_gbps": bytes_model / el / 1e9,
            "pct_hbm_peak": 100.0 * bytes_model / peaks.hbm_bytes_per_s / el,
            "pct_flops_peak": None,  # elementwise stream, no tile products
            "flops_per_s": 2 * eplan.n_products / el,
            "device_kind": peaks.kind,
        }

    # tile path: time exactly the launches spgemm ran, in one fenced loop
    # (tiles passed as jit args so they are not baked in as constants).  A
    # result's retained ``host_state`` supplies the worklists/tiles
    # directly (one plan, one BSR build per CLI run); otherwise they are
    # rebuilt here.
    from spada_tpu.ops.worklist import build_worklist

    dtype = np.float32
    if config.engine_dtype == "bfloat16":
        dtype = jnp.bfloat16

    if host_state is not None:
        segments = host_state["segments"]
        tk, tn = host_state["tk"], host_state["tn"]
        if not segments:
            return None
        return _time_segments(segments, tk, tn, config, dtype, peaks)

    segments = []  # (wl, a_tiles, b_tiles, tm)
    if dataflow == "spada" and plan is not None:
        from spada_tpu.plan.planner import iter_plan_segments

        b_bsr = BsrMatrix.from_csr(b, plan.tile_k, plan.tile_n, dtype=dtype)
        for tm_, _, _, a_bsr, wl in iter_plan_segments(a, b_bsr, plan,
                                                       dtype):
            segments.append((wl, a_bsr.tiles, b_bsr.tiles, tm_))
        tk, tn = plan.tile_k, plan.tile_n
    else:
        if dataflow == "op":
            from spada_tpu.plan.planner import plan_op_dataflow

            tm_, _ = plan_op_dataflow(a, b, config)
        else:
            tm_ = {"ip": 128}.get(dataflow, config.default_tm)
            if dataflow == "rowwise":
                tm_ = _multirow_tm(config)
        order = "k" if dataflow == "op" else "row"
        if dataflow == "spada" and config.densify == "auto":
            # mirror spgemm()'s C-invariant densification so the timing
            # measures the layout that actually ran
            from spada_tpu.plan.densify import (apply_densify,
                                                choose_densify)

            dplan = choose_densify(a, b, tm_, config.tile_k, config.tile_n,
                                   config, allow_row_perm=False)
            if not dplan.is_identity:
                a, b = apply_densify(a, b, dplan)
        a_bsr = BsrMatrix.from_csr(a, tm_, config.tile_k, dtype=dtype)
        b_bsr = BsrMatrix.from_csr(b, config.tile_k, config.tile_n,
                                   dtype=dtype)
        wl = build_worklist(a_bsr, b_bsr, order=order)
        if wl.n_items:
            segments.append((wl, a_bsr.tiles, b_bsr.tiles, tm_))
        tk, tn = config.tile_k, config.tile_n
    if not segments:
        return None
    return _time_segments(segments, tk, tn, config, dtype, peaks)


def _time_segments(segments, tk, tn, config, dtype, peaks):
    import jax.numpy as jnp

    from spada_tpu.ops.engine import select_engine
    from spada_tpu.utils.timing import device_time

    args, metas = [], []
    flops = 0
    bytes_model = 0
    isz = int(np.dtype(dtype).itemsize)
    for wl, at_, bt_, tm_ in segments:
        args += [jnp.asarray(at_), jnp.asarray(bt_)]
        metas.append((wl, tm_))
        flops += 2 * wl.n_items * tm_ * tk * tn
        bytes_model += (wl.n_items * (tm_ * tk + tk * tn) * isz
                        + wl.n_c_tiles * tm_ * tn * 4)

    def fn(*xs):
        return tuple(
            run_worklist(wl, xs[2 * i], xs[2 * i + 1],
                         precision=config.precision, engine=config.engine)
            for i, (wl, _) in enumerate(metas))

    el = device_time(fn, tuple(args))
    engine = (config.engine if config.engine != "auto"
              else select_engine(metas[0][0].order, config.precision))
    return {
        "engine": engine,
        "engine_s": el,
        "hbm_gbps": bytes_model / el / 1e9,
        "pct_hbm_peak": 100.0 * bytes_model / peaks.hbm_bytes_per_s / el,
        "pct_flops_peak": 100.0 * flops / el / peaks.flops(
            isz, config.precision),
        "flops_per_s": flops / el,
        "device_kind": peaks.kind,
    }


def _multirow_tm(config: SpadaConfig) -> int:
    """MultiRow panel height: the config block shape's row count
    (main.rs:67-72 — MultiRow runs the configured ``block_shape``), clamped
    to a matmul-viable height; degenerate shapes (the stock row1 config's
    ``[1, inf]``) fall back to a moderate fixed panel."""
    bs_tm = int(config.block_shape[0])
    return bs_tm if 8 <= bs_tm <= 512 else 32


def spgemm_csr(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    dataflow: Optional[str] = None,
    tm: Optional[int] = None,
    prune_eps: float = 0.0,
) -> CsrMatrix:
    """SpGEMM with CSR output, streaming C through a bounded tile budget.

    The block-sparse result buffer is [nC, tm, tn] f32; when nC exceeds
    ``config.dense_c_budget`` the worklist is executed in consecutive
    output-tile slabs (the o-sorted order makes slabbing a pure index-range
    split), each slab extracted to CSR and concatenated — the two-phase
    symbolic+numeric path for nnz(C) >> device memory (SURVEY.md §5.7: the
    psum spill machinery of storage.rs:599-735 replaced by exact slab
    allocation).
    """
    config = config or SpadaConfig()
    dataflow = dataflow or config.dataflow
    if dataflow == "element":
        return spgemm(a, b, config, dataflow="element").to_csr()
    if dataflow == "op":
        # k-major order has no o-slab structure; fall back to one shot
        # (tm=None lets plan_op_dataflow pick the panel height)
        return spgemm(a, b, config, dataflow=dataflow, tm=tm).to_csr(prune_eps)
    if tm is None:
        if dataflow == "rowwise":
            tm = _multirow_tm(config)
        else:
            tm = {"ip": 128}.get(dataflow, config.default_tm)

    dtype = np.float32
    if config.engine_dtype == "bfloat16":
        import jax.numpy as jnp

        dtype = jnp.bfloat16
    a_bsr = BsrMatrix.from_csr(a, tm, config.tile_k, dtype=dtype)
    b_bsr = BsrMatrix.from_csr(b, config.tile_k, config.tile_n, dtype=dtype)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    shape = (a.shape[0], b.shape[1])
    if wl.n_items == 0:
        return CsrMatrix(shape, np.zeros(shape[0] + 1, np.int64), [], [])

    slab_tiles = max(1, int(config.dense_c_budget) // (tm * config.tile_n * 4))

    parts = []
    for o_lo in range(0, wl.n_c_tiles, slab_tiles):
        o_hi = min(o_lo + slab_tiles, wl.n_c_tiles)
        lo = int(np.searchsorted(wl.o_tid, o_lo))
        hi = int(np.searchsorted(wl.o_tid, o_hi))
        sub = WorkList(
            a_tid=wl.a_tid[lo:hi], b_tid=wl.b_tid[lo:hi],
            o_tid=wl.o_tid[lo:hi] - o_lo, first=wl.first[lo:hi].copy(),
            c_tile_row=wl.c_tile_row[o_lo:o_hi],
            c_tile_col=wl.c_tile_col[o_lo:o_hi],
            n_c_tiles=o_hi - o_lo, order="row",
        )
        if len(sub.first):
            sub.first[0] = 1
        tiles = np.asarray(run_worklist(
            sub, a_bsr.tiles, b_bsr.tiles, precision=config.precision,
            engine=config.engine,
        ))
        t, r, c = np.nonzero(np.abs(tiles) > prune_eps)
        rows = sub.c_tile_row[t].astype(np.int64) * tm + r
        cols = sub.c_tile_col[t].astype(np.int64) * config.tile_n + c
        keep = (rows < shape[0]) & (cols < shape[1])
        parts.append((rows[keep], cols[keep], tiles[t, r, c][keep]))

    return CsrMatrix.from_coo(
        shape,
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.concatenate([p[2] for p in parts]),
    )
