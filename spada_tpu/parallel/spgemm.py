"""Device-side sharded SpGEMM over a (dp, tp) mesh.

One ``shard_map`` launch: every (dp, tp) shard runs the tile engine on its
local worklist; the partial C tiles produced by the tp shards of a dp row
panel are combined with ``jax.lax.psum`` over ``tp`` — the distributed
psum-merge (SURVEY.md §5.7/5.8: the reference's merge-task graph,
scheduler.rs:381-480, as a collective).  C stays sharded over ``dp``
(each device owns its row panel), so the only cross-device traffic is the
tp-merge; dp is communication-free, matching the row-partitioned Gustavson
decomposition.  Every input is placed with its (dp, tp) sharding, so each
device holds only its own shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from spada_tpu.parallel.partition import ShardedProblem
from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class ShardedResult:
    """C tiles per dp panel plus assembly metadata."""

    problem: ShardedProblem
    c_tiles: np.ndarray       # [n_dp, nCmax+1, tm, tn] (last slot = dump)

    def todense(self) -> np.ndarray:
        p = self.problem
        d = np.zeros(p.shape, np.float32)
        for dp in range(p.n_dp):
            nC = int(p.n_c_tiles[dp])
            for t in range(nC):
                r0 = int(p.row_base[dp]) + int(self.c_tile_row[dp, t]) * p.tm
                c0 = int(self.c_tile_col[dp, t]) * p.tn
                h = min(p.tm, p.shape[0] - r0)
                w = min(p.tn, p.shape[1] - c0)
                if h > 0 and w > 0:
                    d[r0 : r0 + h, c0 : c0 + w] += self.c_tiles[dp, t, :h, :w]
        return d

    @property
    def c_tile_row(self):
        return self.problem.c_tile_row

    @property
    def c_tile_col(self):
        return self.problem.c_tile_col

    def to_csr(self) -> CsrMatrix:
        p = self.problem
        rows_all, cols_all, vals_all = [], [], []
        for dp in range(p.n_dp):
            nC = int(p.n_c_tiles[dp])
            tiles = self.c_tiles[dp, :nC]
            t, r, c = np.nonzero(tiles)
            rows = p.row_base[dp] + p.c_tile_row[dp, t].astype(np.int64) * p.tm + r
            cols = p.c_tile_col[dp, t].astype(np.int64) * p.tn + c
            keep = (rows < p.shape[0]) & (cols < p.shape[1])
            rows_all.append(rows[keep])
            cols_all.append(cols[keep])
            vals_all.append(tiles[t, r, c][keep])
        if not rows_all:
            return CsrMatrix(
                p.shape, np.zeros(p.shape[0] + 1, np.int64), [], []
            )
        return CsrMatrix.from_coo(
            p.shape,
            np.concatenate(rows_all),
            np.concatenate(cols_all),
            np.concatenate(vals_all),
        )


def _merge_tp(c, mesh: Mesh, merge: str):
    """Combine the tp shards' k-partial C tiles over the mesh.

    ``'reduce_scatter'`` moves (tp-1)/tp of the C bytes once and leaves
    each tp rank holding a tile-range shard (reassembled by the out
    spec); ``'psum'`` all-reduces (2x the bytes) and replicates C over
    tp.  Both are the distributed merge-task graph (scheduler.rs:381-480)
    as a collective.
    """
    n_tp = mesh.shape["tp"]
    if n_tp == 1:
        # nothing to merge; even an identity psum costs an HBM round trip
        return c
    if merge == "reduce_scatter":
        pad = (-c.shape[0]) % n_tp
        if pad:
            c = jnp.concatenate(
                [c, jnp.zeros((pad,) + c.shape[1:], c.dtype)]
            )
        return jax.lax.psum_scatter(c, "tp", scatter_dimension=0,
                                    tiled=True)
    return jax.lax.psum(c, axis_name="tp")


def make_sharded_fn(mesh: Mesh, n_c_tiles: int, chunk: int = 1024,
                    precision=jax.lax.Precision.HIGHEST,
                    merge: str = "reduce_scatter"):
    """Build the jitted shard_map SpGEMM (XLA scatter engine per shard).

    The returned fn takes the stacked per-shard arrays of
    :class:`ShardedProblem` and returns C tiles [n_dp, >=n_c_tiles+1, tm,
    tn] (slice to ``n_c_tiles`` + dump slot).  See :func:`_merge_tp` for
    the ``merge`` choices.  :func:`make_sharded_triton_fn` runs the tile
    kernel per shard instead.
    """
    from spada_tpu.ops.engine import accumulate_xla

    n_tp = mesh.shape["tp"]

    def per_shard(a_tid, b_tid, o_tid, a_tiles, b_tiles):
        # shard_map passes blocks with leading mesh dims of size 1; C has
        # one extra dump slot (index n_c_tiles) for padded work items
        at, bt = a_tiles[0, 0], b_tiles[0, 0]
        c = jnp.zeros((n_c_tiles + 1, at.shape[1], bt.shape[2]),
                      jnp.float32)
        c = accumulate_xla(c, a_tid[0, 0], b_tid[0, 0], o_tid[0, 0], at, bt,
                           chunk, precision)
        return _merge_tp(c, mesh, merge)[None]

    out_tp = merge == "reduce_scatter" and n_tp > 1
    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P("dp", "tp"),) * 5,
        # reduce_scatter: tp ranks hold consecutive tile ranges; the out
        # spec concatenates them back along the tile dim
        out_specs=P("dp", "tp") if out_tp else P("dp"),
        # n_tp == 1 skips the merge collective (it would cost an HBM round
        # trip for nothing), so tp-replication cannot be statically
        # inferred; correctness is covered by the scipy-parity tests
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_triton_fn(mesh: Mesh, n_c_tiles: int,
                           merge: str = "reduce_scatter",
                           interpret: bool = False):
    """shard_map SpGEMM running the run-accumulating tile kernel
    (:func:`spada_tpu.ops.engine.run_worklist_triton`) on every shard's
    o-sorted worklist.  The returned fn takes (run_ptr, a_tid, b_tid,
    a_tiles, b_tiles) with leading [n_dp, n_tp] dims; ``run_ptr`` covers
    ``n_c_tiles + 1`` tiles (the dump slot included).  Output layout
    matches :func:`make_sharded_fn`."""
    from spada_tpu.ops.engine import _run_triton

    n_tp = mesh.shape["tp"]

    def per_shard(run_ptr, a_tid, b_tid, a_tiles, b_tiles):
        c = _run_triton(run_ptr[0, 0], a_tid[0, 0], b_tid[0, 0],
                        a_tiles[0, 0], b_tiles[0, 0],
                        n_c_tiles=n_c_tiles + 1, precision="default",
                        interpret=interpret)
        return _merge_tp(c, mesh, merge)[None]

    out_tp = merge == "reduce_scatter" and n_tp > 1
    fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P("dp", "tp"),) * 5,
        out_specs=P("dp", "tp") if out_tp else P("dp"),
        # pallas_call's out ShapeDtypeStruct carries no varying-mesh-axes
        # annotation, so the vma checker cannot see through it
        check_vma=False,
    )
    return jax.jit(fn)


def shard_run_pointers(o_tid: np.ndarray, n_c_tiles: int) -> np.ndarray:
    """Run pointers [..., n_c_tiles + 1] of stacked o-sorted worklists."""
    from spada_tpu.ops.engine import run_pointer

    flat = o_tid.reshape(-1, o_tid.shape[-1])
    ptr = np.stack([run_pointer(o, n_c_tiles) for o in flat])
    return ptr.reshape(o_tid.shape[:-1] + (n_c_tiles + 1,))


def spgemm_sharded(
    problem: ShardedProblem,
    mesh: Optional[Mesh] = None,
    chunk: int = 1024,
    merge: str = "reduce_scatter",
    engine: str = "auto",
    engine_dtype=None,
    interpret: bool = False,
) -> ShardedResult:
    """Execute a partitioned SpGEMM over the mesh (default: all devices).

    ``engine``: ``'triton'`` runs the tile kernel on every shard (bf16
    tiles by default, f32 accumulation); ``'xla'`` runs the portable f32
    HIGHEST scatter-add engine; ``'auto'`` picks triton on a GPU and xla
    elsewhere.  ``interpret=True`` runs the kernel on the CPU (tests).
    """
    from jax.sharding import NamedSharding

    from spada_tpu.platform import on_gpu

    if engine == "auto":
        engine = "triton" if on_gpu() else "xla"
    if engine not in ("triton", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    if mesh is None:
        devs = np.array(jax.devices()[: problem.n_dp * problem.n_tp])
        mesh = Mesh(devs.reshape(problem.n_dp, problem.n_tp), ("dp", "tp"))
    shard = NamedSharding(mesh, P("dp", "tp"))

    if engine == "triton":
        dtype = engine_dtype or jnp.bfloat16
        fn = make_sharded_triton_fn(mesh, problem.nCmax, merge=merge,
                                    interpret=interpret)
        c = fn(
            jax.device_put(shard_run_pointers(problem.o_tid,
                                              problem.nCmax + 1), shard),
            jax.device_put(problem.a_tid, shard),
            jax.device_put(problem.b_tid, shard),
            jax.device_put(problem.a_tiles.astype(dtype), shard),
            jax.device_put(problem.b_tiles.astype(dtype), shard),
        )
    else:
        fn = make_sharded_fn(mesh, n_c_tiles=problem.nCmax, chunk=chunk,
                             merge=merge)
        c = fn(*(jax.device_put(x, shard) for x in (
            problem.a_tid, problem.b_tid, problem.o_tid,
            problem.a_tiles, problem.b_tiles)))
    # reduce_scatter pads the tile dim to a multiple of tp; drop the pad
    # (the dump slot at index nCmax stays)
    c = np.asarray(c)[:, : problem.nCmax + 1]
    return ShardedResult(problem=problem, c_tiles=c)
