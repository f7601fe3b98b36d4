"""Sparse containers (reference tier-3 MISSING components, spec'd by their
callers: ``tests/blas_like/Multiply.cpp:19-46``, ``tests/lapack_like/
SparseLDL.cpp``, ``examples/interface/BP.py:20-40`` QueueUpdate/ProcessQueues
assembly pattern): ``SparseMatrix`` (CSR), ``Graph`` (pattern), COO builder,
BSR blocks.

Design: the *assembly* side (queues, dedup, symbolic structure)
lives on host in NumPy — it is irregular, latency-bound work that would fight
XLA; the *numeric* side is padded-ELL / CSR-segment device arrays with static
shapes, so SpMV/SpMM compile once per structure and stream at memory
bandwidth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


class SparseBuilder:
    """COO accumulation with the reference's QueueUpdate/ProcessQueues
    protocol (``AbstractDistMatrix.hpp:162-171`` / ``BP.py:20-40``)."""

    def __init__(self, height: int, width: int, dtype=np.float64):
        self.height = height
        self.width = width
        self.dtype = np.dtype(dtype)
        self._rows: list = []
        self._cols: list = []
        self._vals: list = []

    def reserve(self, n: int) -> None:  # parity no-op (lists grow)
        pass

    def queue_update(self, i, j, v) -> None:
        self._rows.append(i)
        self._cols.append(j)
        self._vals.append(v)

    def queue_updates(self, rows, cols, vals) -> None:
        self._rows.extend(np.asarray(rows).tolist())
        self._cols.extend(np.asarray(cols).tolist())
        self._vals.extend(np.asarray(vals).tolist())

    def process_queues(self) -> "SparseMatrix":
        rows = np.asarray(self._rows, dtype=np.int64)
        cols = np.asarray(self._cols, dtype=np.int64)
        vals = np.asarray(self._vals, dtype=self.dtype)
        return SparseMatrix.from_coo(self.height, self.width, rows, cols,
                                     vals)


@dataclasses.dataclass
class SparseMatrix:
    """Local CSR matrix (host index arrays + host values; ``.device()``
    produces the ELL device form used by the compute kernels)."""

    height: int
    width: int
    rowptr: np.ndarray   # int64 (height+1)
    colind: np.ndarray   # int64 (nnz)
    vals: np.ndarray     # dtype (nnz)

    # ---------------- constructors ----------------
    @classmethod
    def from_coo(cls, height: int, width: int, rows, cols, vals,
                 sum_duplicates: bool = True) -> "SparseMatrix":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key = rows * width + cols
            uniq, inv = np.unique(key, return_inverse=True)
            summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(summed, inv, vals)
            rows = (uniq // width).astype(np.int64)
            cols = (uniq % width).astype(np.int64)
            vals = summed
        rowptr = np.zeros(height + 1, np.int64)
        np.add.at(rowptr, rows + 1, 1)
        rowptr = np.cumsum(rowptr)
        return cls(height, width, rowptr, cols, vals)

    @classmethod
    def from_dense(cls, a, tol: float = 0.0) -> "SparseMatrix":
        a = np.asarray(a)
        rows, cols = np.nonzero(np.abs(a) > tol)
        return cls.from_coo(a.shape[0], a.shape[1], rows, cols,
                            a[rows, cols])

    @classmethod
    def from_scipy(cls, m) -> "SparseMatrix":
        m = m.tocsr()
        return cls(m.shape[0], m.shape[1], m.indptr.astype(np.int64),
                   m.indices.astype(np.int64), m.data)

    # ---------------- queries ----------------
    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def dtype(self):
        return self.vals.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.height, self.width), self.vals.dtype)
        rows = np.repeat(np.arange(self.height), self.row_nnz())
        out[rows, self.colind] = self.vals
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.vals, self.colind, self.rowptr),
                             shape=self.shape)

    def graph(self) -> "Graph":
        return Graph(self.height, self.width, self.rowptr.copy(),
                     self.colind.copy())

    # ---------------- transforms ----------------
    def transpose(self) -> "SparseMatrix":
        rows = np.repeat(np.arange(self.height), self.row_nnz())
        return SparseMatrix.from_coo(self.width, self.height, self.colind,
                                     rows, self.vals, sum_duplicates=False)

    def conj(self) -> "SparseMatrix":
        return dataclasses.replace(self, vals=np.conj(self.vals))

    def change_nonzero_values(self, new_vals) -> "SparseMatrix":
        """Same structure, new values (reference ``ChangeNonzeroValues``,
        ``DistSparseLDLFactorization.cpp:149`` — re-factorization reuse)."""
        new_vals = np.asarray(new_vals)
        assert new_vals.shape == self.vals.shape
        return dataclasses.replace(self, vals=new_vals)

    def scale(self, alpha) -> "SparseMatrix":
        return dataclasses.replace(self, vals=self.vals * alpha)

    def symmetric_scale(self, d) -> "SparseMatrix":
        """A ← diag(d)·A·diag(d) without densifying."""
        d = np.asarray(d)
        rows = np.repeat(np.arange(self.height), self.row_nnz())
        return dataclasses.replace(
            self, vals=self.vals * d[rows] * d[self.colind])

    def add(self, other: "SparseMatrix", alpha=1.0) -> "SparseMatrix":
        rows_a = np.repeat(np.arange(self.height), self.row_nnz())
        rows_b = np.repeat(np.arange(other.height), other.row_nnz())
        return SparseMatrix.from_coo(
            self.height, self.width,
            np.concatenate([rows_a, rows_b]),
            np.concatenate([self.colind, other.colind]),
            np.concatenate([self.vals, alpha * other.vals]))

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), self.vals.dtype)
        rows = np.repeat(np.arange(self.height), self.row_nnz())
        mask = rows == self.colind
        d[rows[mask]] = self.vals[mask]
        return d

    def update_diagonal(self, delta) -> "SparseMatrix":
        n = min(self.shape)
        rows = np.repeat(np.arange(self.height), self.row_nnz())
        idx = np.arange(n)
        return self.add(SparseMatrix.from_coo(self.height, self.width, idx,
                                              idx, np.asarray(delta)))

    # ---------------- device forms ----------------
    def host_ell(self, width: Optional[int] = None, pad_align: int = 8):
        """Padded ELL arrays on host: (cols int32 h×w, vals h×w, dropped)."""
        nnzr = self.row_nnz()
        w = int(width if width is not None else (nnzr.max() if len(nnzr)
                                                 else 0))
        w = max(1, ((w + pad_align - 1) // pad_align) * pad_align)
        cols = np.zeros((self.height, w), np.int32)
        vals = np.zeros((self.height, w), self.vals.dtype)
        # vectorized fill
        r = np.repeat(np.arange(self.height), nnzr)
        offs = np.arange(self.nnz) - np.repeat(self.rowptr[:-1], nnzr)
        keep = offs < w
        cols[r[keep], offs[keep]] = self.colind[keep].astype(np.int32)
        vals[r[keep], offs[keep]] = self.vals[keep]
        dropped = int((~keep).sum())
        return cols, vals, dropped

    def device_ell(self, width: Optional[int] = None, pad_align: int = 8,
                   device=None):
        """Padded ELL device form (static shapes for the SpMV kernels)."""
        cols, vals, dropped = self.host_ell(width, pad_align)
        put = (lambda x: jax.device_put(x, device)) if device is not None \
            else jnp.asarray
        return ELLMatrix(self.height, self.width, put(cols), put(vals),
                         dropped)

    def device_csr(self):
        """CSR segment-sum device form (handles any row-length skew)."""
        rows = np.repeat(np.arange(self.height), self.row_nnz())
        return CSRDevice(self.height, self.width,
                         jnp.asarray(rows.astype(np.int32)),
                         jnp.asarray(self.colind.astype(np.int32)),
                         jnp.asarray(self.vals))


@dataclasses.dataclass
class ELLMatrix:
    """Device ELL form: static-shape, vectorizable SpMV."""
    height: int
    width: int
    cols: jnp.ndarray   # (h, w) int32
    vals: jnp.ndarray   # (h, w)
    dropped: int = 0    # entries that exceeded the ELL width (0 = exact)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        # (h, w, k) gather — fused by XLA into a batched gather + reduction
        return jnp.einsum("hw,hwk->hk", self.vals, X[self.cols],
                          optimize=True)


@dataclasses.dataclass
class CSRDevice:
    """Device CSR (row-id segment-sum form): XLA gathers x[colind],
    multiplies, and reduces each row with a sorted ``segment_sum`` — the
    ``csr`` tier of ``plan_spmv`` for matrices DIA does not cover."""
    height: int
    width: int
    rows: jnp.ndarray    # (nnz,) int32, sorted (CSR order)
    colind: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray    # (nnz,)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        prod = self.vals * x[self.colind]
        return jax.ops.segment_sum(prod, self.rows,
                                   num_segments=self.height,
                                   indices_are_sorted=True)

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        prod = self.vals[:, None] * X[self.colind]
        return jax.ops.segment_sum(prod, self.rows,
                                   num_segments=self.height,
                                   indices_are_sorted=True)


# Device containers are pytrees so they can be passed as jit ARGUMENTS
# (convenient composition, and donation/sharding of the leaves).
jax.tree_util.register_dataclass(
    ELLMatrix, data_fields=("cols", "vals"),
    meta_fields=("height", "width", "dropped"))
jax.tree_util.register_dataclass(
    CSRDevice, data_fields=("rows", "colind", "vals"),
    meta_fields=("height", "width"))


@dataclasses.dataclass
class Graph:
    """Pattern-only sparse structure (reference ``Graph``; sources/targets
    adjacency used by the nested-dissection symbolic layer)."""

    num_sources: int
    num_targets: int
    rowptr: np.ndarray
    colind: np.ndarray

    @classmethod
    def from_edges(cls, num_sources: int, num_targets: int, sources,
                   targets) -> "Graph":
        s = np.asarray(sources, np.int64)
        t = np.asarray(targets, np.int64)
        order = np.lexsort((t, s))
        s, t = s[order], t[order]
        key = s * num_targets + t
        uniq = np.unique(key)
        s = (uniq // num_targets).astype(np.int64)
        t = (uniq % num_targets).astype(np.int64)
        rowptr = np.zeros(num_sources + 1, np.int64)
        np.add.at(rowptr, s + 1, 1)
        return cls(num_sources, num_targets, np.cumsum(rowptr), t)

    @property
    def num_edges(self) -> int:
        return int(self.colind.shape[0])

    def neighbors(self, i: int) -> np.ndarray:
        return self.colind[self.rowptr[i]:self.rowptr[i + 1]]

    def symmetrize(self) -> "Graph":
        rows = np.repeat(np.arange(self.num_sources),
                         np.diff(self.rowptr))
        return Graph.from_edges(
            max(self.num_sources, self.num_targets),
            max(self.num_sources, self.num_targets),
            np.concatenate([rows, self.colind]),
            np.concatenate([self.colind, rows]))

    def to_sparse(self, dtype=np.float64) -> SparseMatrix:
        return SparseMatrix(self.num_sources, self.num_targets,
                            self.rowptr.copy(), self.colind.copy(),
                            np.ones(self.num_edges, dtype))


@dataclasses.dataclass
class BSRMatrix:
    """Block-CSR with fixed b×b blocks — the supernodal, matmul-friendly
    format."""

    height: int
    width: int
    block: int
    rowptr: np.ndarray     # (nblockrows+1,)
    colind: np.ndarray     # (nblocks,) block-column indices
    vals: np.ndarray       # (nblocks, b, b)

    @classmethod
    def from_sparse(cls, A: SparseMatrix, block: int) -> "BSRMatrix":
        b = block
        h = ((A.height + b - 1) // b) * b
        w = ((A.width + b - 1) // b) * b
        rows = np.repeat(np.arange(A.height), A.row_nnz())
        brow, bcol = rows // b, A.colind // b
        key = brow * (w // b) + bcol
        uniq, inv = np.unique(key, return_inverse=True)
        vals = np.zeros((uniq.shape[0], b, b), A.vals.dtype)
        np.add.at(vals, (inv, rows % b, A.colind % b), A.vals)
        ubrow = (uniq // (w // b)).astype(np.int64)
        ubcol = (uniq % (w // b)).astype(np.int64)
        rowptr = np.zeros(h // b + 1, np.int64)
        np.add.at(rowptr, ubrow + 1, 1)
        return cls(A.height, A.width, b, np.cumsum(rowptr), ubcol, vals)

    @property
    def nnzb(self) -> int:
        return int(self.colind.shape[0])

    def device(self):
        nnzr = np.diff(self.rowptr)
        wmax = max(1, int(nnzr.max()) if len(nnzr) else 1)
        nbr = len(self.rowptr) - 1
        cols = np.zeros((nbr, wmax), np.int32)
        vals = np.zeros((nbr, wmax, self.block, self.block), self.vals.dtype)
        r = np.repeat(np.arange(nbr), nnzr)
        offs = np.arange(self.nnzb) - np.repeat(self.rowptr[:-1], nnzr)
        cols[r, offs] = self.colind.astype(np.int32)
        vals[r, offs] = self.vals
        return BSRDevice(self.height, self.width, self.block,
                         jnp.asarray(cols), jnp.asarray(vals))

    def to_dense(self) -> np.ndarray:
        b = self.block
        nbr = len(self.rowptr) - 1
        out = np.zeros((nbr * b, (self.width + b - 1) // b * b),
                       self.vals.dtype)
        for br in range(nbr):
            for k in range(self.rowptr[br], self.rowptr[br + 1]):
                bc = self.colind[k]
                out[br * b:(br + 1) * b, bc * b:(bc + 1) * b] += self.vals[k]
        return out[:self.height, :self.width]


@dataclasses.dataclass
class BSRDevice:
    height: int
    width: int
    block: int
    cols: jnp.ndarray   # (nbr, wmax) int32
    vals: jnp.ndarray   # (nbr, wmax, b, b)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        b = self.block
        pad = self.cols.shape[0] * b - x.shape[0]
        xp = jnp.pad(x, (0, max(0, pad))) if pad > 0 else x
        xb = xp.reshape(-1, b)                       # (nbc, b)
        gathered = xb[self.cols]                     # (nbr, wmax, b)
        # batched block matvec: (nbr, wmax, b, b) × (nbr, wmax, b)
        y = jnp.einsum("rwij,rwj->ri", self.vals, gathered, optimize=True)
        return y.reshape(-1)[:self.height]


jax.tree_util.register_dataclass(
    BSRDevice, data_fields=("cols", "vals"),
    meta_fields=("height", "width", "block"))
