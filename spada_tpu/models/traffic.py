"""Functional (round-based) traffic model with reference-exact accounting.

This realizes, without cycle simulation, the measurement capability of the
reference's storage layer and legacy traffic model:

- **Counter semantics** (storage.rs): a CSR row of ``L`` elements occupies and
  moves ``2L`` words (value + index, ``CsrRow::size``, storage.rs:73-75);
  scalar reads count 2 words each (``read_scalars``, storage.rs:314); DRAM row
  appends count ``2L + 1`` (``CsrMatStorage::write``, storage.rs:202); psum
  row writes count ``2L`` (``VectorStorage::write``, storage.rs:380) and
  element writes 2 (storage.rs:454).
- **Fiber cache** (``LatencyPriorityCache``, storage.rs:460-1007):
  word-granular occupancy (``capability = cache_size / word_byte``,
  storage.rs:498); **reference-exact eviction**: a lazily-invalidated min-heap
  of ``[priority, addr]`` where a row's priority is the A-traversal position
  of its most recent access (bumped on writes and on row-start read hits,
  storage.rs:585-590, 775-781) and a freshly allocated psum row's priority is
  its own address (storage.rs:712-717) — psum addresses sit above
  ``output_base_addr`` (main.rs:65), so young psums outrank all B rows on the
  shared number line.  The victim is the MINIMUM ``[priority, addr]``
  (``BinaryHeap<Reverse<_>>``, storage.rs:546-563) — an LRU-style online
  policy with *no* future knowledge.  When the resident B words cannot cover a
  space request, an arbitrary psum row is evicted instead (storage.rs:603-611;
  the reference takes HashMap iteration order — this model deterministically
  takes the lowest psum address).  Clean drop for B rows, write-back to psum
  DRAM for psum rows (storage.rs:626-648); counters ``miss_count``,
  ``b_evict_count``, ``psum_evict_count``, read/write word counts.
  Miss fills count ``miss_count`` + cache ``write_count`` but **not** cache
  ``read_count`` (request_read_scalars' miss branch, storage.rs:792-818);
  destructive merge reads count ``read_count`` on hits and both
  ``read_count`` and ``miss_count`` on DRAM refills
  (request_consume_scalars, storage.rs:856-913).
- **Reuse ratios** (storage_traffic_model.rs:131-164): ``b_reuse`` = touched
  B-fiber words / distinct B-fiber words; ``c_reuse`` = touched psum words /
  final C words.

One deliberate divergence: a single row larger than the whole cache bypasses
residency here (streamed), where the reference panics
(``freeup_space``→``write``, storage.rs:565-658).

The model executes a row-wise Gustavson schedule over an
:class:`~spada_tpu.plan.planner.ExecutionPlan`'s row panels (or a fixed panel
height) and optionally splits each row's contraction range into windows of
``window_k`` A-scalars, in which case partial psums are produced per window
and pairwise-merged at row end — the PE-merge/adder-tree traffic
(scheduler.rs:381-480, 820-920) in functional form.

It is *deterministic and exact* for the schedule it models; tests assert its
counters against closed forms on synthetic matrices, its eviction decisions
against hand-walked schedules, and its computed product against scipy.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from spada_tpu.config import SpadaConfig
from spada_tpu.sparse.csr import CsrMatrix

INF = np.iinfo(np.int64).max


@dataclasses.dataclass
class MemStats:
    """DRAM element counters (``CsrMatStorage``/``VectorStorage``)."""

    read_count: int = 0
    write_count: int = 0


@dataclasses.dataclass
class CacheStats:
    """Fiber-cache counters (storage.rs:465-478)."""

    read_count: int = 0
    write_count: int = 0
    miss_count: int = 0
    b_evict_count: int = 0
    psum_evict_count: int = 0
    max_occupancy: int = 0
    fill_count: int = 0   # number of DRAM->cache fill *events* (latency model)


@dataclasses.dataclass
class TrafficReport:
    """The reference's emitted metrics (main.rs:102-111) plus reuse ratios."""

    a_mem: MemStats
    b_mem: MemStats
    psum_mem: MemStats
    cache: CacheStats
    b_touched_words: int
    b_distinct_words: int
    c_touched_words: int
    c_final_words: int
    word_byte: int = 8
    # per-window / per-merge task components for the latency accumulation
    # (simulator.rs:589-631): set by the Python model, None on the native
    # full-K fast path.  window_tasks rows: (mults, psum_len, traffic_words,
    # n_fills); merge_tasks rows: (merged_len, traffic_words, refilled)
    window_tasks: Optional[np.ndarray] = None
    merge_tasks: Optional[np.ndarray] = None

    @property
    def b_reuse(self) -> float:
        return self.b_touched_words / max(self.b_distinct_words, 1)

    @property
    def c_reuse(self) -> float:
        return self.c_touched_words / max(self.c_final_words, 1)

    @property
    def dram_bytes(self) -> int:
        """Total modeled DRAM traffic in bytes."""
        words = (
            self.a_mem.read_count + self.a_mem.write_count
            + self.b_mem.read_count + self.b_mem.write_count
            + self.psum_mem.read_count + self.psum_mem.write_count
        )
        return words * self.word_byte

    def estimated_cycles(self, config=None, useful_mults: int = 0) -> int:
        """Analytical cycle estimate on the reference's simulated machine.

        The reference measures cycles where each window costs
        ``max(observed compute cycles, memory_traffic / BW-share)``
        (simulator.rs:589-631) and every fill gates its window behind
        ``mem_latency + cache_latency`` via ``pending_request``
        (storage.rs:737-774).  The functional analog takes the max of the
        three machine-wide bounds:

        - **compute**: scalar multiplies across ``pe_num * lane_num`` lanes,
          plus the merge cost — every produced psum element passes through a
          sorting-network/merge-tree (one element per cycle per unit,
          simulator.rs:117-235, adder_tree.rs:145-171), modeled at
          ``pe_num + at_num`` elements/cycle machine-wide.
        - **memory**: modeled DRAM words over the configured bandwidth.
        - **latency**: each of the ``fill_count`` miss fills exposes
          ``mem_latency + cache_latency`` stall cycles to its PE; with
          ``pe_num`` PEs filling independently the machine-wide exposure is
          ``fill_count * per_fill / pe_num``.

        When the Python model ran, ``windowed_cycles`` carries the tighter
        per-window accumulation — each window/merge task costs
        ``max(compute, traffic / BW-share, exposed fill latency)`` and the
        sums are divided across the units that run them (PEs for windows,
        adder trees for merges), exactly the shape of the reference's
        accounting at simulator.rs:589-631 — and is preferred over the
        machine-wide max.  The native full-K fast path reports only the
        machine-wide bounds.

        This is the exec-cycle metric of ``main.rs:104`` at roofline
        (round-based) accuracy; tests validate it against hand-walked
        schedules.
        """
        from spada_tpu.config import SpadaConfig

        config = config or SpadaConfig()
        mem_cycles = int(
            self.dram_bytes / max(config.bandwidth_bytes_per_cycle, 1e-9)
        )
        if self.window_tasks is not None:
            # per-window accumulation folds compute/traffic/latency maxima
            # per task; the machine-wide DRAM bound stays as a floor
            # (windows on different PEs still share one memory system)
            return max(self.windowed_cycles(config), mem_cycles)
        lanes = max(config.pe_num * config.lane_num, 1)
        mult_cycles = useful_mults // lanes
        merge_units = max(config.pe_num + config.at_num, 1)
        merge_cycles = (self.c_touched_words // 2) // merge_units
        compute_cycles = mult_cycles + merge_cycles
        per_fill = config.mem_latency + config.cache_latency
        latency_cycles = (
            self.cache.fill_count * per_fill // max(config.pe_num, 1)
        )
        return max(compute_cycles, mem_cycles, latency_cycles)

    def windowed_cycles(self, config=None) -> int:
        """Per-task latency accumulation (simulator.rs:589-631).

        Each window task costs ``max(compute, traffic / PE-bandwidth-share,
        exposed fill latency)`` where compute is the slower of the lane
        multipliers and the sorting-network/merge-tree drain (1 element per
        cycle) plus their pipeline latency, and only the first fill's
        latency is exposed (later fills overlap compute across the window's
        lane stream buffers, storage.rs:737-774).  Merge tasks run on the
        adder trees (1 min-element per cycle, adder_tree.rs:145-171).
        Window tasks spread over pe_num PEs and merge tasks over at_num
        adder trees, concurrently (simulator.rs:529, 838): elapsed is the
        slower of the two balanced sums.
        """
        from spada_tpu.config import SpadaConfig

        config = config or SpadaConfig()
        per_fill = config.mem_latency + config.cache_latency
        pe_bw = config.bandwidth_bytes_per_cycle / max(config.pe_num, 1)
        at_bw = config.bandwidth_bytes_per_cycle / max(config.at_num, 1)
        pe_sum = 0
        if self.window_tasks is not None and len(self.window_tasks):
            wt = self.window_tasks
            compute = (np.maximum(
                -(-wt[:, 0] // max(config.lane_num, 1)), wt[:, 1])
                + config.sn_latency + config.mt_latency)
            traffic = (wt[:, 2] * config.word_byte / pe_bw).astype(np.int64)
            lat = np.where(wt[:, 3] > 0, per_fill, 0)
            pe_sum = int(np.maximum(np.maximum(compute, traffic), lat).sum())
        at_sum = 0
        if self.merge_tasks is not None and len(self.merge_tasks):
            mt = self.merge_tasks
            compute = mt[:, 0] + config.mt_latency
            traffic = (mt[:, 1] * config.word_byte / at_bw).astype(np.int64)
            lat = np.where(mt[:, 2] > 0, per_fill, 0)
            at_sum = int(np.maximum(np.maximum(compute, traffic), lat).sum())
        return max(-(-pe_sum // max(config.pe_num, 1)),
                   -(-at_sum // max(config.at_num, 1)))

    def as_dict(self) -> dict:
        return {
            "a_mem_read": self.a_mem.read_count,
            "b_mem_read": self.b_mem.read_count,
            "psum_mem_read": self.psum_mem.read_count,
            "psum_mem_write": self.psum_mem.write_count,
            "cache_read": self.cache.read_count,
            "cache_write": self.cache.write_count,
            "miss_count": self.cache.miss_count,
            "fill_count": self.cache.fill_count,
            "b_evict_count": self.cache.b_evict_count,
            "psum_evict_count": self.cache.psum_evict_count,
            "b_reuse": self.b_reuse,
            "c_reuse": self.c_reuse,
            "dram_bytes": self.dram_bytes,
        }


class _FiberCache:
    """Reference-exact priority cache (``LatencyPriorityCache``).

    Keys are ``('b', row_id)`` or ``('p', psum_uid)``; the address of a psum
    key is ``output_base + uid`` (psum address space starts above B's row
    ids, main.rs:65).  Priorities are A-traversal positions of the most
    recent access (``valid_pq_row_dict`` max-bump, storage.rs:585-590), except
    fresh psum rows whose priority is their own address (storage.rs:712-717).
    Eviction pops the MINIMUM ``[priority, addr]`` from a lazily-invalidated
    heap (storage.rs:546-563, 617-625) — least-recently-used at A-row
    granularity, no future knowledge.
    """

    def __init__(self, capacity_words: int, stats: CacheStats,
                 output_base: int):
        self.capacity = capacity_words
        self.stats = stats
        self.output_base = output_base
        self.occ = 0
        self.b_occ = 0
        self.rows: Dict[Tuple[str, int], int] = {}     # key -> words
        self.prio: Dict[Tuple[str, int], int] = {}     # valid_pq_row_dict
        self.heap: List[Tuple[int, int, Tuple[str, int]]] = []

    def addr_of(self, key) -> int:
        return key[1] if key[0] == "b" else self.output_base + key[1]

    def contains(self, key) -> bool:
        return key in self.rows

    def _bump(self, key, prio_val: int) -> None:
        """valid_pq_row_dict max-bump + heap push (storage.rs:585-590)."""
        p = max(self.prio.get(key, prio_val), prio_val)
        self.prio[key] = p
        heapq.heappush(self.heap, (p, self.addr_of(key), key))

    def touch(self, key, prio_val: int) -> None:
        """Row-start read hit: bump recency (storage.rs:775-781)."""
        self._bump(key, prio_val)

    def _freeup_space(self, words: int, pinned, on_evict) -> None:
        """Evict until ``words`` fit (freeup_space, storage.rs:599-658)."""
        while self.occ + words > self.capacity:
            victim = None
            if self.b_occ < words:
                # all B rows together can't cover it: take a psum row
                # (storage.rs:603-611; deterministic lowest-address here)
                psums = [k for k in self.rows
                         if k[0] == "p" and k != pinned]
                if psums:
                    victim = min(psums, key=self.addr_of)
            if victim is None:
                while self.heap:
                    p, _, key = heapq.heappop(self.heap)
                    # lazy invalidation (storage.rs:617-625)
                    if key not in self.rows or self.prio.get(key) != p:
                        continue
                    if key == pinned:
                        continue
                    victim = key
                    break
            if victim is None:
                return  # nothing evictable (reference panics; we stream)
            vwords = self.rows.pop(victim)
            self.occ -= vwords
            if victim[0] == "b":
                self.b_occ -= vwords
            on_evict(victim, vwords)

    def insert(self, key, words: int, prio_val: int, on_evict) -> None:
        """Insert a row (``write``/``append_psum_to``, storage.rs:565-733).

        A row larger than the whole cache bypasses residency (streamed) —
        a deliberate divergence from the reference's panic.
        """
        self._freeup_space(words, key, on_evict)
        if self.occ + words <= self.capacity:
            self.rows[key] = words
            self.occ += words
            if key[0] == "b":
                self.b_occ += words
            self._bump(key, prio_val)
            self.stats.max_occupancy = max(self.stats.max_occupancy, self.occ)

    def remove(self, key) -> int:
        words = self.rows.pop(key, 0)
        if words and key[0] == "b":
            self.b_occ -= words
        self.occ -= words
        return words


@dataclasses.dataclass
class FunctionalResult:
    report: TrafficReport
    c: CsrMatrix


def simulate_traffic(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    row_order: Optional[np.ndarray] = None,
    window_k: Optional[int] = None,
    compute_values: bool = True,
    backend: str = "auto",
) -> FunctionalResult:
    """Run the functional traffic model for a row-wise Gustavson schedule.

    - ``row_order``: traversal order of A's rows (default: natural; the
      planner's panel order or the ``-p`` sorted order can be passed).
    - ``window_k``: split each row's scalars into windows of this many
      A-elements; each window yields a partial psum, pairwise-merged at row
      end (models the PE-merge path).  ``None`` = one full-K window.
    - ``backend``: 'auto' uses the native (C++) cache walk for the full-K
      structure-only case, the reference-exact Python model otherwise;
      'python' / 'native' force a path.
    """
    config = config or SpadaConfig()
    if row_order is None:
        row_order = np.arange(a.row_num, dtype=np.int64)

    if backend != "python" and window_k is None and not compute_values:
        res = _simulate_native(a, b, config, row_order)
        if res is not None:
            return res
        if backend == "native":
            raise RuntimeError("native traffic backend unavailable")

    a_mem, b_mem, psum_mem = MemStats(), MemStats(), MemStats()
    cstats = CacheStats()
    # psum address space starts above B's row-pointer array (main.rs:65)
    output_base = b.shape[0] + 1
    cache = _FiberCache(config.cache_words, cstats, output_base)

    b_lens = b.row_lens()

    b_touched_words = 0
    c_touched_words = 0
    c_final_words = 0
    touched_b_rows: set = set()

    def evict_cb(key, words):
        kind = key[0]
        if kind == "b":
            cstats.b_evict_count += words  # clean drop (storage.rs:646)
        else:
            cstats.psum_evict_count += words
            psum_mem.write_count += words  # write-back (storage.rs:626-641)

    out_rows: List[np.ndarray] = []
    out_cols: List[np.ndarray] = []
    out_vals: List[np.ndarray] = []

    # ---- per-window latency accumulation (simulator.rs:589-631) ----
    # raw task components collected here; TrafficReport.windowed_cycles
    # folds them under any machine config
    window_tasks: List[Tuple[int, int, int, int]] = []
    merge_tasks: List[Tuple[int, int, int]] = []

    def dram_words() -> int:
        return (a_mem.read_count + a_mem.write_count + b_mem.read_count
                + b_mem.write_count + psum_mem.read_count
                + psum_mem.write_count)

    psum_uid = 0
    for i, r in enumerate(row_order):
        s, e = a.indptr[r], a.indptr[r + 1]
        n_scalars = int(e - s)
        if n_scalars == 0:
            continue
        wk = window_k or n_scalars
        partials: List[Tuple[int, np.ndarray, np.ndarray]] = []  # (uid, cols, vals)
        for ws in range(0, n_scalars, wk):
            w_dram0 = dram_words()
            w_fills0 = cstats.fill_count
            # A scalars fetched per window (read_scalars, scheduler.rs:556)
            a_mem.read_count += 2 * min(wk, n_scalars - ws)
            wcols = a.indices[s + ws : s + min(ws + wk, n_scalars)].astype(np.int64)
            wvals = a.data[s + ws : s + min(ws + wk, n_scalars)]
            w_mults = int(b_lens[wcols].sum())
            seg_cols: List[np.ndarray] = []
            seg_vals: List[np.ndarray] = []
            for j, k in enumerate(wcols):
                k = int(k)
                words = int(2 * b_lens[k])
                if words:
                    b_touched_words += words
                    key = ("b", k)
                    if cache.contains(key):
                        # hit: count the readout, bump recency
                        # (storage.rs:775-791)
                        cstats.read_count += words
                        cache.touch(key, i)
                    else:
                        # miss: DRAM fill, cache write; the readout itself is
                        # NOT a cache read (storage.rs:792-818)
                        b_mem.read_count += words
                        cstats.miss_count += words
                        cstats.fill_count += 1
                        cstats.write_count += words
                        cache.insert(key, words, i, evict_cb)
                    if k not in touched_b_rows:
                        touched_b_rows.add(k)
                bs, be = b.indptr[k], b.indptr[k + 1]
                if be > bs:
                    seg_cols.append(b.indices[bs:be].astype(np.int64))
                    if compute_values:
                        seg_vals.append(b.data[bs:be] * wvals[j])
            if not seg_cols:
                continue
            cat_cols = np.concatenate(seg_cols)
            if compute_values:
                cat_vals = np.concatenate(seg_vals)
                ucols, seg = np.unique(cat_cols, return_inverse=True)
                uvals = np.zeros(len(ucols), dtype=cat_vals.dtype)
                np.add.at(uvals, seg, cat_vals)
            else:
                ucols = np.unique(cat_cols)
                uvals = np.zeros(0)
            pw = int(2 * len(ucols))
            c_touched_words += pw
            cstats.write_count += pw  # psum row into cache (append_psum_to)
            # fresh psum priority = its own address (storage.rs:712-717)
            key = ("p", psum_uid)
            cache.insert(key, pw, cache.addr_of(key), evict_cb)
            partials.append((psum_uid, ucols, uvals))
            psum_uid += 1
            window_tasks.append((w_mults, len(ucols),
                                 dram_words() - w_dram0,
                                 cstats.fill_count - w_fills0))

        # pairwise-merge partials (merge_task semantics, scheduler.rs:381-480)
        while len(partials) > 1:
            merged: List[Tuple[int, np.ndarray, np.ndarray]] = []
            for idx in range(0, len(partials) - 1, 2):
                m_dram0 = dram_words()
                m_psum_reads0 = psum_mem.read_count
                u1, c1, v1 = partials[idx]
                u2, c2, v2 = partials[idx + 1]
                for uid, cc in ((u1, c1), (u2, c2)):
                    w = int(2 * len(cc))
                    if cache.contains(("p", uid)):
                        # destructive read from cache
                        # (request_consume_scalars hit, storage.rs:860-890)
                        cstats.read_count += w
                        cache.remove(("p", uid))
                    else:
                        # refill from DRAM: counts a cache read AND a miss
                        # (request_consume_scalars miss, storage.rs:892-913)
                        psum_mem.read_count += w
                        cstats.read_count += w
                        cstats.miss_count += w
                    c_touched_words += w
                if compute_values:
                    cat_c = np.concatenate([c1, c2])
                    cat_v = np.concatenate([v1, v2])
                    mc, seg = np.unique(cat_c, return_inverse=True)
                    mv = np.zeros(len(mc), dtype=cat_v.dtype)
                    np.add.at(mv, seg, cat_v)
                else:
                    mc = np.union1d(c1, c2)
                    mv = np.zeros(0)
                mw = int(2 * len(mc))
                cstats.write_count += mw
                key = ("p", psum_uid)
                cache.insert(key, mw, cache.addr_of(key), evict_cb)
                merged.append((psum_uid, mc, mv))
                psum_uid += 1
                merge_tasks.append((len(mc), dram_words() - m_dram0,
                                    psum_mem.read_count - m_psum_reads0))
            if len(partials) % 2:
                merged.append(partials[-1])
            partials = merged

        if partials:
            uid, fc, fv = partials[0]
            fw = int(2 * len(fc))
            # finished row: swap out to DRAM (swapout_finished_psums,
            # simulator.rs:985-1006)
            if cache.contains(("p", uid)):
                cache.remove(("p", uid))
            psum_mem.write_count += fw
            c_final_words += fw
            out_rows.append(np.full(len(fc), r, dtype=np.int64))
            out_cols.append(fc)
            out_vals.append(
                fv if compute_values else np.ones(len(fc), dtype=np.float64)
            )

    c = CsrMatrix.from_coo(
        (a.shape[0], b.shape[1]),
        np.concatenate(out_rows) if out_rows else np.zeros(0, np.int64),
        np.concatenate(out_cols) if out_cols else np.zeros(0, np.int64),
        np.concatenate(out_vals) if out_vals else np.zeros(0),
    )
    b_distinct_words = int(2 * sum(int(b_lens[k]) for k in touched_b_rows))
    report = TrafficReport(
        a_mem=a_mem, b_mem=b_mem, psum_mem=psum_mem, cache=cstats,
        b_touched_words=b_touched_words, b_distinct_words=b_distinct_words,
        c_touched_words=c_touched_words, c_final_words=c_final_words,
        word_byte=config.word_byte,
        window_tasks=np.asarray(window_tasks, dtype=np.int64).reshape(-1, 4),
        merge_tasks=np.asarray(merge_tasks, dtype=np.int64).reshape(-1, 3),
    )
    return FunctionalResult(report=report, c=c)


def _simulate_native(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig,
                     row_order: np.ndarray) -> Optional[FunctionalResult]:
    """Full-K structure-only fast path via the C++ cache walk.

    The merged-psum sizes (= C's row nnz) come from a scipy boolean product;
    the reference-exact priority-cache walk runs natively.  Counter semantics
    are identical to the Python model (asserted in tests).
    """
    from spada_tpu import native


    a_sp = a.to_scipy().astype(bool)
    b_sp = b.to_scipy().astype(bool)
    c_sp = (a_sp @ b_sp).tocsr()
    c_row_nnz = np.diff(c_sp.indptr).astype(np.int64)
    res = native.traffic_simulate(
        a.indptr, a.indices, b.row_lens(), row_order,
        config.cache_words, c_row_nnz[row_order],
    )
    if res is None:
        return None
    out, row_traffic, row_fills = res
    # full-K window tasks (one per row with a nonempty psum), same
    # components as the Python model's accumulation
    b_lens = b.row_lens()
    fan = b_lens[a.indices]
    cs = np.concatenate([[0], np.cumsum(fan)])
    row_mults = (cs[a.indptr[1:]] - cs[a.indptr[:-1]])[row_order]
    psum_len = c_row_nnz[row_order]
    live = psum_len > 0
    window_tasks = np.stack(
        [row_mults[live], psum_len[live], row_traffic[live],
         row_fills[live]], axis=1
    ).astype(np.int64) if live.any() else np.zeros((0, 4), np.int64)
    report = TrafficReport(
        a_mem=MemStats(read_count=int(out[0])),
        b_mem=MemStats(read_count=int(out[1])),
        psum_mem=MemStats(read_count=int(out[2]), write_count=int(out[3])),
        cache=CacheStats(
            read_count=int(out[10]), write_count=int(out[11]),
            miss_count=int(out[4]), b_evict_count=int(out[5]),
            psum_evict_count=int(out[6]), max_occupancy=int(out[13]),
            fill_count=int(out[14]),
        ),
        b_touched_words=int(out[7]), b_distinct_words=int(out[8]),
        c_touched_words=int(out[9]), c_final_words=int(out[12]),
        word_byte=config.word_byte,
        window_tasks=window_tasks,
        merge_tasks=np.zeros((0, 3), np.int64),  # full-K: no merge rounds
    )
    c = CsrMatrix(
        c_sp.shape, c_sp.indptr.astype(np.int64), c_sp.indices,
        np.ones(c_sp.nnz, dtype=np.float64), check=False,
    )
    return FunctionalResult(report=report, c=c)
