"""Sparse neural-net layers — the "NN" workload family as a live model.

The reference's NN category is a pickle of sparse layer GEMMs consumed
offline (py2rust.rs:5-60).  Here the family is a *runnable model*: a
block-sparse linear layer whose weight tiles are the same BSR payloads the
SpGEMM engine consumes, with a jittable/differentiable SpMM forward — tile
payloads are dense arrays, so sparse-structure-fixed training works with
plain ``jax.grad``.

``spmm`` is the dense-right-hand-side sibling of the worklist engine: one
tile product per nonzero weight tile per activation slab, segment-summed into
row panels (the same multiply-merge dataflow with a trivially dense merge).

``make_sharded_train_step`` shards activations' batch over ``dp`` and the
contraction (tile-k) over ``tp``; the tp partial-output merge is a
``psum`` — the same collective realization of the reference's merge path as
:mod:`spada_tpu.parallel.spgemm` — and dp weight-gradient averaging is the
standard data-parallel psum XLA inserts for the backward pass.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu.sparse.csr import CsrMatrix


@dataclasses.dataclass
class SparseLinearSpec:
    """Static structure of one block-sparse weight matrix [out, in]."""

    n_tile_rows: int     # out / tm
    n_k_tiles: int       # in / tk
    tm: int
    tk: int
    tile_row: np.ndarray  # int32 [n_tiles]
    tile_col: np.ndarray  # int32 [n_tiles] (k-tile index)

    @classmethod
    def from_bsr(cls, w: BsrMatrix) -> "SparseLinearSpec":
        return cls(
            n_tile_rows=w.n_tile_rows,
            n_k_tiles=w.n_tile_cols,
            tm=w.tm, tk=w.tn,
            tile_row=w.tile_rows(), tile_col=w.tile_col.astype(np.int32),
        )


def spmm(tiles, spec: SparseLinearSpec, x):
    """y = W @ x for block-sparse W (tile payloads ``tiles``) and dense x.

    ``tiles``: f32 [n_tiles, tm, tk] — the trainable parameter.
    ``x``: f32 [in_pad, batch] with in_pad = n_k_tiles * tk.
    Returns [out_pad, batch].
    """
    n = x.shape[1]
    xt = x.reshape(spec.n_k_tiles, spec.tk, n)
    parts = jax.lax.dot_general(
        tiles, xt[spec.tile_col],
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )
    y = jnp.zeros((spec.n_tile_rows, spec.tm, n), jnp.float32)
    y = y.at[spec.tile_row].add(parts)
    return y.reshape(spec.n_tile_rows * spec.tm, n)


@dataclasses.dataclass
class SparseMLP:
    """Flagship model: block-sparse MLP acting on column-major activations."""

    specs: List[SparseLinearSpec]
    params: List[np.ndarray]          # tile payloads per layer

    @classmethod
    def from_density(
        cls, dims: Tuple[int, ...], density: float, tm: int = 128,
        tk: int = 128, seed: int = 0,
    ) -> "SparseMLP":
        """Random block-sparse MLP: dims = (in, hidden..., out)."""
        rng = np.random.default_rng(seed)
        specs, params = [], []
        prev_rows = None
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            n_tr = -(-fan_out // tm)
            n_kt = -(-fan_in // tk)
            total = n_tr * n_kt
            n_keep = max(1, int(total * density))
            chosen = rng.choice(total, size=n_keep, replace=False)
            chosen.sort()
            trow = (chosen // n_kt).astype(np.int32)
            tcol = (chosen % n_kt).astype(np.int32)
            # connectivity guard: at sparse densities a layer's kept
            # k-tiles can entirely miss the previous layer's nonzero
            # output row panels — a structurally DEAD network whose
            # forward is exactly zero (observed at density 0.25 seed 0).
            # Rewire one tile's k onto a live input slab if so.
            if prev_rows is not None and not (set(tcol.tolist())
                                              & prev_rows):
                tcol[0] = np.int32(rng.choice(sorted(prev_rows)))
            prev_rows = set(trow.tolist())
            scale = np.sqrt(2.0 / max(fan_in * density, 1.0))
            tiles = rng.standard_normal((n_keep, tm, tk)).astype(np.float32) * scale
            specs.append(SparseLinearSpec(n_tr, n_kt, tm, tk, trow, tcol))
            params.append(tiles)
        return cls(specs, params)

    @classmethod
    def from_csr_weights(cls, weights: List[CsrMatrix], tm: int = 128,
                         tk: int = 128) -> "SparseMLP":
        specs, params = [], []
        for w in weights:
            bsr = BsrMatrix.from_csr(w, tm, tk, dtype=np.float32)
            specs.append(SparseLinearSpec.from_bsr(bsr))
            params.append(bsr.tiles)
        return cls(specs, params)

    @property
    def in_pad(self) -> int:
        return self.specs[0].n_k_tiles * self.specs[0].tk

    @property
    def out_pad(self) -> int:
        return self.specs[-1].n_tile_rows * self.specs[-1].tm

    def forward(self, params, x):
        """x: [in_pad, batch] -> [out_pad, batch]; relu between layers."""
        h = x
        for i, spec in enumerate(self.specs):
            h = spmm(params[i], spec, h)
            if i + 1 < len(self.specs):
                h = jax.nn.relu(h)
            if i + 1 < len(self.specs):
                # pad/trim to the next layer's expected input height
                want = self.specs[i + 1].n_k_tiles * self.specs[i + 1].tk
                if h.shape[0] < want:
                    h = jnp.pad(h, ((0, want - h.shape[0]), (0, 0)))
                elif h.shape[0] > want:
                    h = h[:want]
        return h

    def loss(self, params, x, y):
        pred = self.forward(params, x)
        return jnp.mean((pred - y) ** 2)


def make_train_step(model: SparseMLP, lr: float = 1e-3):
    """Single-device jittable SGD step on the tile payloads."""

    @jax.jit
    def step(params, x, y):
        l, grads = jax.value_and_grad(model.loss)(params, x, y)
        new_params = [p - lr * g for p, g in zip(params, grads)]
        return new_params, l

    return step


def make_sharded_train_step(model: SparseMLP, mesh: Mesh, lr: float = 1e-3):
    """Training step over a ('dp','tp') mesh.

    - batch (columns of x / y) sharded over dp,
    - each layer's weight tiles sharded over tp by tile index (balanced
      round-robin; tile payloads are independent rows of the tile array),
    - forward: every tp shard computes the partial y from its tiles,
      merged by ``psum`` over tp (the distributed multiply-merge);
    - backward: ``jax.grad`` through the shard_map inserts the mirror
      collectives; dp-mean of the loss makes weight grads dp-averaged.

    Weights are passed (and updated) in tp-sharded layout
    ``[n_tp, max_tiles, tm, tk]``.  Per-shard tile coordinates travel as
    tp-sharded int32 DATA, not as per-branch constants under a
    ``lax.switch`` on ``axis_index``: with branch-constant gather indices
    the value is typed tp-invariant, so shard_map's VMA transpose inserts
    the activation-cotangent ``psum`` on the *gathered slice* BEFORE each
    shard's index-specific scatter — cross-contaminating shards and
    silently corrupting every layer-(i) gradient that feeds a tp-split
    layer (i+1) (caught by test_sharded_step_equals_single_device).
    Index arrays entering through ``in_specs=P('tp')`` are varying-typed,
    which lands the transpose psum on the full activation cotangent.
    """
    n_tp = mesh.shape["tp"]

    # --- host: round-robin tiles to tp shards, pad to equal count ---
    shard_params: List[np.ndarray] = []              # [layer] -> [tp, Tmax, tm, tk]
    shard_masks: List[np.ndarray] = []               # [layer] -> [tp, Tmax, 1, 1]
    shard_trow: List[np.ndarray] = []                # [layer] -> [tp, Tmax]
    shard_tcol: List[np.ndarray] = []
    for spec, tiles in zip(model.specs, model.params):
        n_tiles = tiles.shape[0]
        owner = np.arange(n_tiles) % n_tp
        per_tp = [np.nonzero(owner == t)[0] for t in range(n_tp)]
        tmax = max(1, max(len(ix) for ix in per_tp))
        buf = np.zeros((n_tp, tmax) + tiles.shape[1:], tiles.dtype)
        mask = np.zeros((n_tp, tmax, 1, 1), tiles.dtype)
        trow = np.zeros((n_tp, tmax), np.int32)
        tcol = np.zeros((n_tp, tmax), np.int32)
        for t, ix in enumerate(per_tp):
            buf[t, : len(ix)] = tiles[ix]
            mask[t, : len(ix)] = 1.0
            # padded slots point at tile-row 0 with zero payload — inert in
            # the FORWARD pass only: their loss gradient is nonzero
            # (dL/dy[rows 0..tm] @ x[k-tile 0]^T), so the SGD update must
            # mask it or step 2 onward adds spurious products into tile-row
            # 0 (caught by test_sharded_padded_slots_stay_inert)
            trow[t, : len(ix)] = spec.tile_row[ix]
            tcol[t, : len(ix)] = spec.tile_col[ix]
        shard_params.append(buf)
        shard_masks.append(mask)
        shard_trow.append(trow)
        shard_tcol.append(tcol)

    def local_spmm(tiles, trow, tcol, spec: SparseLinearSpec, x):
        n = x.shape[1]
        xt = x.reshape(spec.n_k_tiles, spec.tk, n)
        parts = jax.lax.dot_general(
            tiles, xt[tcol],
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        y = jnp.zeros((spec.n_tile_rows, spec.tm, n), jnp.float32)
        y = y.at[trow].add(parts)
        return y.reshape(spec.n_tile_rows * spec.tm, n)

    def local_forward(params_tp, trow_tp, tcol_tp, x):
        h = x
        for i, spec in enumerate(model.specs):
            parts = local_spmm(
                params_tp[i][0], trow_tp[i][0], tcol_tp[i][0], spec, h)
            h = jax.lax.psum(parts, "tp")
            if i + 1 < len(model.specs):
                h = jax.nn.relu(h)
                want = model.specs[i + 1].n_k_tiles * model.specs[i + 1].tk
                if h.shape[0] < want:
                    h = jnp.pad(h, ((0, want - h.shape[0]), (0, 0)))
                elif h.shape[0] > want:
                    h = h[:want]
        return h

    def shard_loss(params_tp, trow_tp, tcol_tp, x, y):
        pred = local_forward(params_tp, trow_tp, tcol_tp, x)
        # mean over the global batch: local mean then dp-mean
        return jax.lax.pmean(jnp.mean((pred - y) ** 2), "dp")

    def per_shard_step(params_tp, trow_tp, tcol_tp, masks_tp, x, y):
        # x/y arrive as the local dp block [in_pad, batch/n_dp]; params /
        # indices / masks as [1, ...] (tp-sharded dim 0)
        l, grads = jax.value_and_grad(shard_loss)(
            params_tp, trow_tp, tcol_tp, x, y)
        # mask padded slots out of the update
        new_params = [
            p - lr * g * m
            for p, g, m in zip(params_tp, grads, masks_tp)
        ]
        return new_params, l[None]

    pspecs = [P("tp") for _ in shard_params]
    step = jax.shard_map(
        per_shard_step,
        mesh=mesh,
        in_specs=(pspecs, pspecs, pspecs, pspecs, P(None, "dp"), P(None, "dp")),
        out_specs=(pspecs, P("dp")),
    )

    @jax.jit
    def public_step(params_tp, x, y):
        return step(
            params_tp,
            [jnp.asarray(a) for a in shard_trow],
            [jnp.asarray(a) for a in shard_tcol],
            [jnp.asarray(a) for a in shard_masks],
            x, y,
        )

    return public_step, shard_params
