"""Block-sparse (BSR) device format.

The replacement for the reference's element-granular fibers: the tile
kernels consume dense (tm, tn) tiles, so sparsity is exploited at *tile*
granularity.  This is the rebuild's counterpart of the reference's
block/window decomposition (``BlockTracker``/``WindowTracker``,
scheduler.rs:69-137): a Spada "block" of shape [h, w] over A becomes a row
panel of height ``tm`` whose nonzero (tm, tk) tiles feed tile matmuls.

Host-side construction is pure NumPy; the device arrays form a pytree that is
jit/shard_map friendly (static shapes, int32 index vectors).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spada_tpu.sparse.csr import CsrMatrix


def tiles_of_csr(m: CsrMatrix, tm: int, tn: int):
    """Return (tile_row, tile_col, count) for every nonzero (tm, tn) tile.

    Sorted row-major (tile_row, then tile_col).  ``count`` is the number of
    scalar nonzeros that fall in each tile — the planner's density signal
    (the analog of ``a_cols_num`` per block row, scheduler.rs:87-93).
    """
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    trow = rows // tm
    tcol = m.indices.astype(np.int64) // tn
    key = trow * ((m.shape[1] + tn - 1) // tn) + tcol
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    uniq, counts = np.unique(key_sorted, return_counts=True)
    n_tile_cols = (m.shape[1] + tn - 1) // tn
    return (uniq // n_tile_cols).astype(np.int32), (uniq % n_tile_cols).astype(np.int32), counts.astype(np.int64)


@dataclasses.dataclass
class BsrValueMap:
    """Precomputed CSR-data -> tile-payload scatter for one structure.

    The device tile format, like the ESC operand layout, is built once per
    SPARSITY STRUCTURE; refreshing values for the same structure (the
    reference's NN mode — static pruning masks, per-batch activation
    values, py2rust.rs:5-60) is then a single vectorized host scatter via
    this map instead of a full ``from_csr`` rebuild (index sort + unique).
    """

    tm: int
    tn: int
    n_tiles: int
    scat_tile: np.ndarray      # [nnz] int32 tile id per CSR data position
    scat_r: np.ndarray         # [nnz] int32 in-tile row
    scat_c: np.ndarray         # [nnz] int32 in-tile col
    tile_col: np.ndarray
    tile_rowptr: np.ndarray
    nnz_per_tile: np.ndarray
    dtype: object = np.float32

    @classmethod
    def from_structure(cls, m: CsrMatrix, tm: int, tn: int,
                       dtype=np.float32) -> "BsrValueMap":
        n_tile_rows = -(-m.shape[0] // tm)
        n_tile_cols = -(-m.shape[1] // tn)
        rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
        cols = m.indices.astype(np.int64)
        key = (rows // tm) * n_tile_cols + cols // tn
        uniq = np.unique(key)
        tile_id = np.searchsorted(uniq, key).astype(np.int32)
        n_tiles = len(uniq)
        counts = np.zeros(max(n_tiles, 1), dtype=np.int64)
        if len(rows):
            np.add.at(counts, tile_id, 1)
        tile_col = (uniq % n_tile_cols).astype(np.int32)
        tile_rowptr = np.zeros(n_tile_rows + 1, dtype=np.int64)
        np.add.at(tile_rowptr, (uniq // n_tile_cols) + 1, 1)
        tile_rowptr = np.cumsum(tile_rowptr)
        if n_tiles == 0:
            tile_col = np.zeros(1, dtype=np.int32)
            counts = np.zeros(1, dtype=np.int64)
            # keep one explicit zero tile in row 0 so device arrays are
            # nonempty
            tile_rowptr = np.zeros(n_tile_rows + 1, dtype=np.int64)
            tile_rowptr[1:] = 1
        return cls(tm, tn, n_tiles, tile_id,
                   (rows % tm).astype(np.int32), (cols % tn).astype(np.int32),
                   tile_col, tile_rowptr, counts, dtype)

    def fill(self, data: np.ndarray) -> np.ndarray:
        """Scatter one CSR data array into a fresh [n_tiles, tm, tn] tile
        payload (duplicates accumulate, matching CSR semantics)."""
        tiles = np.zeros((max(self.n_tiles, 1), self.tm, self.tn),
                         dtype=self.dtype)
        if len(self.scat_tile):
            np.add.at(tiles, (self.scat_tile, self.scat_r, self.scat_c),
                      np.asarray(data).astype(self.dtype))
        return tiles


@dataclasses.dataclass
class BsrMatrix:
    """Row-major block-sparse matrix with dense (tm, tn) tiles.

    Attributes:
      shape: logical (rows, cols) before padding.
      tm, tn: tile shape.
      tiles: float array [n_tiles, tm, tn] — dense tile payloads.
      tile_col: int32 [n_tiles] — tile-column index of each tile.
      tile_rowptr: int64 [n_tile_rows + 1] — CSR-style pointer over tiles.
      nnz_per_tile: int64 [n_tiles] — scalar nonzeros inside each tile.
    """

    shape: Tuple[int, int]
    tm: int
    tn: int
    tiles: np.ndarray
    tile_col: np.ndarray
    tile_rowptr: np.ndarray
    nnz_per_tile: np.ndarray

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_tile_rows(self) -> int:
        return int(len(self.tile_rowptr) - 1)

    @property
    def n_tile_cols(self) -> int:
        return -(-self.shape[1] // self.tn)

    @classmethod
    def from_csr(cls, m: CsrMatrix, tm: int, tn: int, dtype=np.float32) -> "BsrMatrix":
        vm = BsrValueMap.from_structure(m, tm, tn, dtype=dtype)
        return cls((m.shape[0], m.shape[1]), tm, tn, vm.fill(m.data),
                   vm.tile_col, vm.tile_rowptr, vm.nnz_per_tile)

    def refill(self, vm: "BsrValueMap", data: np.ndarray) -> "BsrMatrix":
        """New BsrMatrix with fresh values through a prebuilt value map
        (same structure; the tile metadata is shared, not copied).

        Guards that ``vm`` was built for this matrix's tiling/structure —
        a mismatched map would scatter into the wrong tiles silently."""
        if (vm.tm != self.tm or vm.tn != self.tn
                or max(vm.n_tiles, 1) != self.n_tiles
                or len(data) != len(vm.scat_tile)):
            raise ValueError(
                f"value map mismatch: map is ({vm.tm}x{vm.tn}, "
                f"{vm.n_tiles} tiles, nnz {len(vm.scat_tile)}) but matrix "
                f"is ({self.tm}x{self.tn}, {self.n_tiles} tiles, "
                f"data len {len(data)})")
        return dataclasses.replace(self, tiles=vm.fill(data))

    def tile_rows(self) -> np.ndarray:
        """Expand tile_rowptr to a per-tile tile-row index."""
        return np.repeat(
            np.arange(self.n_tile_rows), np.diff(self.tile_rowptr)
        ).astype(np.int32)

    def occupancy(self) -> float:
        """Scalar nnz / dense tile capacity — tile-product efficiency signal."""
        cap = self.n_tiles * self.tm * self.tn
        return float(self.nnz_per_tile.sum()) / cap if cap else 0.0

    def todense(self) -> np.ndarray:
        n_rows_pad = self.n_tile_rows * self.tm
        n_cols_pad = self.n_tile_cols * self.tn
        d = np.zeros((n_rows_pad, n_cols_pad), dtype=self.tiles.dtype)
        trows = self.tile_rows()
        for t in range(self.n_tiles):
            r0 = int(trows[t]) * self.tm
            c0 = int(self.tile_col[t]) * self.tn
            d[r0 : r0 + self.tm, c0 : c0 + self.tn] += self.tiles[t]
        return d[: self.shape[0], : self.shape[1]]
