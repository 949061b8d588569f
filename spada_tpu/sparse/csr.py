"""Host-side CSR container.

Counterpart of the reference's DRAM storage model
(``CsrMatStorage``, storage.rs:150-458): flat ``indptr/indices/data`` arrays
with optional lazy row remapping (``reorder_row``, storage.rs:252-255) and
element counting helpers (``get_ele_num``).  Unlike the reference this is a
plain data container — traffic accounting lives in
:mod:`spada_tpu.models.traffic`.
"""

from __future__ import annotations

import numpy as np


class CsrMatrix:
    """CSR matrix over NumPy arrays (host side, pre-planning)."""

    def __init__(
        self,
        shape,
        indptr: np.ndarray,
        indices: np.ndarray,
        data: np.ndarray,
        check: bool = True,
    ):
        self.shape = (int(shape[0]), int(shape[1]))
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.data = np.asarray(data)
        if check:
            if self.indptr.ndim != 1 or len(self.indptr) != self.shape[0] + 1:
                raise ValueError("bad indptr length")
            if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
                raise ValueError("bad indptr bounds")
            if len(self.indices) != len(self.data):
                raise ValueError("indices/data length mismatch")
            if np.any(np.diff(self.indptr) < 0):
                raise ValueError("indptr not monotone")

    # ---- constructors ----
    @classmethod
    def from_scipy(cls, m) -> "CsrMatrix":
        m = m.tocsr()
        return cls(m.shape, m.indptr, m.indices, m.data)

    @classmethod
    def from_coo(cls, shape, rows, cols, vals) -> "CsrMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # sum duplicate coordinates
        if len(rows):
            key_change = np.empty(len(rows), dtype=bool)
            key_change[0] = True
            key_change[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            seg = np.cumsum(key_change) - 1
            rows_u = rows[key_change]
            cols_u = cols[key_change]
            vals_u = np.zeros(seg[-1] + 1, dtype=vals.dtype)
            np.add.at(vals_u, seg, vals)
        else:
            rows_u, cols_u, vals_u = rows, cols, vals
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows_u + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(shape, indptr, cols_u, vals_u)

    @classmethod
    def from_dense(cls, d: np.ndarray) -> "CsrMatrix":
        rows, cols = np.nonzero(d)
        return cls.from_coo(d.shape, rows, cols, d[rows, cols])

    # ---- basic queries ----
    @property
    def nnz(self) -> int:
        return int(len(self.data))

    @property
    def row_num(self) -> int:
        return self.shape[0]

    @property
    def col_num(self) -> int:
        return self.shape[1]

    def row_lens(self) -> np.ndarray:
        """nnz per row (the scheduler's ``a_row_lens`` / ``b_row_lens``)."""
        return np.diff(self.indptr).astype(np.int64)

    def get_ele_num(self, row_s: int, row_t: int) -> int:
        """Elements in rows [row_s, row_t) (storage.rs ``get_ele_num``)."""
        return int(self.indptr[row_t] - self.indptr[row_s])

    def row(self, i: int):
        s, t = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:t], self.data[s:t]

    # ---- transforms ----
    def transpose(self) -> "CsrMatrix":
        """CSR transpose via COO re-sort (counterpart of sprs ``transpose_into``)."""
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        return CsrMatrix.from_coo(
            (self.shape[1], self.shape[0]), self.indices, rows, self.data
        )

    def reorder_rows(self, perm: np.ndarray) -> "CsrMatrix":
        """Return a copy with row ``i`` taken from old row ``perm[i]``.

        Realizes ``reorder_row`` (storage.rs:252-255) eagerly — the
        remap must be materialized before device transfer anyway.
        """
        perm = np.asarray(perm, dtype=np.int64)
        lens = self.row_lens()[perm]
        indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(lens)
        # gather element ranges
        idx = np.concatenate(
            [np.arange(self.indptr[p], self.indptr[p + 1]) for p in perm]
        ) if len(perm) else np.zeros(0, dtype=np.int64)
        return CsrMatrix(self.shape, indptr, self.indices[idx], self.data[idx])

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(self.shape, self.indptr, self.indices,
                         self.data.astype(dtype), check=False)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    def todense(self) -> np.ndarray:
        d = np.zeros(self.shape, dtype=self.data.dtype if len(self.data) else np.float64)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))
        d[rows, self.indices] = self.data
        return d

    def __repr__(self) -> str:
        return f"CsrMatrix(shape={self.shape}, nnz={self.nnz}, dtype={self.data.dtype})"
