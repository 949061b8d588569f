"""Distributed element-granular SpGEMM: dp row partition over a mesh.

The ESC element path (ops/element.py) is per-row separable, so its natural
distribution is the row-partitioned Gustavson decomposition with ZERO
cross-device communication: each device owns a row slab of A (and of C),
plans its own expansion locally, and streams its padded buckets — the
distributed analog of the reference's per-PE window assignment
(scheduler.rs:482-606) where rows never share state.  Contrast with the
tile path's tp psum-merge (parallel/spgemm.py) and halo exchange
(parallel/halo.py): scattered structure needs neither, because the element
plan already gathered every B operand value host-side.

Slabs are balanced by expansion size E (the actual work/byte count), not
row count — the power-law degree skew this engine targets makes row-count
balance meaningless (one hub row can carry 100x the products).

Device program: one ``shard_map`` over ('dp',) whose body is the same
zero-indexed-op multiply + fixed-width reduction as the single-chip engine;
per-class bucket arrays are padded to the max shard shape and stacked on a
leading dp axis (padding multiplies zeros into chunk slots that map
nowhere).  The jaxpr contains no collective at all — asserted in tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class ElementDpProblem:
    """Host-planned dp decomposition of an element-path SpGEMM."""

    shape: Tuple[int, int]
    n_dev: int
    row_bounds: List[int]              # [n_dev + 1] row slab boundaries
    plans: list                        # per-shard EscPlan
    classes: Tuple[int, ...]           # sorted union of bucket classes L
    # per class: stacked operands [n_dev, n_max, L] and true chunk count
    # per shard [n_dev]
    a_stacked: List[np.ndarray]
    b_stacked: List[np.ndarray]
    n_chunks: List[np.ndarray]

    @property
    def e_per_shard(self) -> np.ndarray:
        return np.array([p.n_products for p in self.plans], np.int64)


def partition_element(a: CsrMatrix, b: CsrMatrix, n_dev: int,
                      cap: int = 512,
                      dtype=np.float32) -> ElementDpProblem:
    """Balance row slabs by expansion size E and plan each shard locally."""
    from spada_tpu.ops.element import (build_esc_plan, esc_operands,
                                       expansion_products)

    blen = np.diff(b.indptr).astype(np.int64)
    fan = blen[a.indices]
    cs = np.concatenate([[0], np.cumsum(fan)])
    row_e = cs[a.indptr[1:]] - cs[a.indptr[:-1]]
    total = int(row_e.sum())
    # greedy balanced split: cut where cumulative E passes k/n_dev of total;
    # matrices with fewer rows than devices leave trailing shards empty
    # (bounds may repeat — a zero-row slab plans to an empty bucket set)
    cum = np.cumsum(row_e)
    m = a.shape[0]
    bounds = [0]
    for k in range(1, n_dev):
        r = int(np.searchsorted(cum, total * k / n_dev))
        bounds.append(min(max(r, bounds[-1] + 1), m))
    bounds.append(m)

    from spada_tpu.ops.element import _slice_rows

    plans, opss = [], []
    for s, t in zip(bounds[:-1], bounds[1:]):
        sub = _slice_rows(a, s, t)
        plan = build_esc_plan(sub, b, cap=cap)
        plans.append(plan)
        opss.append(esc_operands(plan, sub, b, dtype=dtype))

    classes = tuple(sorted({bk.L for p in plans for bk in p.buckets}))
    a_stacked, b_stacked, n_chunks = [], [], []
    for L in classes:
        per = []
        for p, ops in zip(plans, opss):
            hit = [(bk, op) for bk, op in zip(p.buckets, ops) if bk.L == L]
            if hit:
                per.append(hit[0][1])
            else:
                per.append((np.zeros((0, L), dtype), np.zeros((0, L), dtype)))
        n_max = max(av.shape[0] for av, _ in per)
        n_max = max(n_max, 1)
        # L=1 stacks ship flat [n_dev, n_max] (see esc_operands: a trailing
        # [.,1] dim costs a device layout-copy pass to squeeze)
        shp = (n_dev, n_max) if L == 1 else (n_dev, n_max, L)
        av_st = np.zeros(shp, dtype)
        bv_st = np.zeros(shp, dtype)
        cnt = np.zeros(n_dev, np.int64)
        for d, (av, bv) in enumerate(per):
            av_st[d, : av.shape[0]] = av if av.ndim == len(shp) - 1 \
                else av[:, 0]
            bv_st[d, : bv.shape[0]] = bv if bv.ndim == len(shp) - 1 \
                else bv[:, 0]
            cnt[d] = av.shape[0]
        a_stacked.append(av_st)
        b_stacked.append(bv_st)
        n_chunks.append(cnt)
    return ElementDpProblem((a.shape[0], b.shape[1]), n_dev, bounds, plans,
                            classes, a_stacked, b_stacked, n_chunks)


@dataclasses.dataclass
class ElementDpResult:
    problem: ElementDpProblem
    values: list      # per class: [n_dev, n_max] chunk values (padded)

    def to_csr(self) -> CsrMatrix:
        """Assemble per-shard ESC chunk values into the global CSR."""
        p = self.problem
        csrs = []
        for d, plan in enumerate(p.plans):
            # re-interleave this shard's per-class chunk values back into
            # the plan's esc (bucket-concatenated) order
            parts = []
            for bk in plan.buckets:
                ci = p.classes.index(bk.L)
                nd = bk.a_gidx.shape[0]
                parts.append(np.asarray(self.values[ci][d][:nd]))
            vals = (np.concatenate(parts) if parts
                    else np.zeros(0, np.float32))
            data = np.zeros(plan.nnz_c, np.float64)
            np.add.at(data, plan.esc_to_csr, vals.astype(np.float64))
            csrs.append(CsrMatrix(plan.shape, plan.indptr, plan.indices,
                                  data.astype(np.float32)))
        from spada_tpu.ops.element import concat_row_slabs

        return concat_row_slabs(p.shape, csrs)

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()


def build_dp_program(problem: ElementDpProblem, mesh=None):
    """(shard_mapped fn, device operand list) — exposed so tests can assert
    the jaxpr of the REAL program contains no collectives.

    Each operand is placed with its dp sharding, so every device holds
    only its own slab.  The per-shard body is the single-chip XLA
    executor: a multiply and a row sum per length class."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    if mesh is None:
        devs = jax.devices()[: problem.n_dev]
        mesh = Mesh(np.array(devs), ("dp",))

    n_classes = len(problem.classes)

    def local(*flat):
        outs = []
        for i in range(n_classes):
            av, bv = flat[2 * i][0], flat[2 * i + 1][0]
            prod = (av * bv).astype(jnp.float32)
            if prod.ndim == 1 or prod.shape[1] == 1:
                outs.append(prod.reshape(1, -1))
            else:
                outs.append(jnp.sum(prod, axis=1)[None])
        return tuple(outs)

    shard = NamedSharding(mesh, P("dp"))
    flat = []
    for av, bv in zip(problem.a_stacked, problem.b_stacked):
        flat += [jax.device_put(av, shard), jax.device_put(bv, shard)]
    fn = shard_map(
        local, mesh=mesh,
        in_specs=tuple(P("dp") for _ in flat),
        out_specs=tuple(P("dp") for _ in range(n_classes)),
    )
    return fn, flat


def spgemm_element_dp(problem: ElementDpProblem,
                      mesh=None) -> ElementDpResult:
    """One communication-free shard_map launch over ('dp',)."""
    import jax

    fn, flat = build_dp_program(problem, mesh)
    vals = jax.jit(fn)(*flat)
    # normalize to [n_dev, flat-chunk]; padding is tail-only, so [:nd]
    # slices stay valid
    n_dev = problem.n_dev
    return ElementDpResult(
        problem, [np.asarray(v).reshape(n_dev, -1) for v in vals])
