"""MatrixMarket I/O.

Counterpart of ``trilinos_tpu/io/matrix_market.py`` (the analogue of
Tpetra's MatrixMarket reader and writer, MatrixMarket_Tpetra.hpp:165,1642):
host code, copied. Coordinate files (real, integer, pattern, complex;
general, symmetric, skew-symmetric, hermitian) and array (dense) files.
``read_sparse`` takes the port's native parser for coordinate files given
by path. ``read_sparse_distributed`` reads a file and row-partitions it
into a ``parallel.distmatrix.DistMatrix``.
"""
from __future__ import annotations

import gzip
import io as _io
import os

import numpy as np

from ..native import read_mm_native
from ..ops.formats import CsrHost


def _open(path_or_file, mode="rt"):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    p = str(path_or_file)
    if p.endswith(".gz"):
        return gzip.open(p, mode), True
    return open(p, mode), True


def read_sparse(path_or_file) -> CsrHost:
    """Read a MatrixMarket file into a host CSR matrix.

    Fast path: the port's native C++ parser for coordinate files given by
    path (``read_sparse.native_calls``); the Python parser serves file
    objects, the array format, complex and hermitian files, and every file
    when the native library is unavailable (``read_sparse.python_calls``).
    Both give the same CsrHost."""
    if isinstance(path_or_file, (str, bytes, os.PathLike)):
        got = read_mm_native(os.fsdecode(path_or_file))
        if got is not None:
            read_sparse.native_calls += 1
            rows, cols, vals, shape, symm = got
            if symm in (1, 2):
                off = rows != cols
                sgn = -1.0 if symm == 2 else 1.0
                rows2 = np.concatenate([rows, cols[off]])
                cols2 = np.concatenate([cols, rows[off]])
                vals2 = np.concatenate([vals, sgn * vals[off]])
                rows, cols, vals = rows2, cols2, vals2
            return CsrHost.from_coo(rows, cols, vals, shape,
                                    sum_duplicates=True)
    read_sparse.python_calls += 1
    f, should_close = _open(path_or_file)
    try:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"not a MatrixMarket file: {header[:40]!r}")
        parts = header.strip().split()
        if len(parts) < 5:
            raise ValueError(f"malformed MatrixMarket header: {header!r}")
        _, obj, fmt, field, symm = parts[:5]
        obj, fmt = obj.lower(), fmt.lower()
        field, symm = field.lower(), symm.lower()
        if obj != "matrix":
            raise ValueError(f"unsupported object {obj!r}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        sizes = line.split()
        if fmt == "coordinate":
            m, n, nnz = int(sizes[0]), int(sizes[1]), int(sizes[2])
            data = np.loadtxt(f, dtype=np.float64, max_rows=nnz, ndmin=2)
            if len(data) != nnz:
                raise ValueError(
                    f"expected {nnz} entries, found {len(data)}")
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(nnz)
            elif field == "complex":
                # four columns: row col Re Im (the reference's templated
                # reader handles complex Scalars the same way,
                # MatrixMarket_Tpetra.hpp); a host CsrHost with complex
                # values, which no solve of the port takes yet
                vals = data[:, 2] + 1j * data[:, 3]
            else:
                vals = data[:, 2]
            if symm in ("symmetric", "skew-symmetric", "hermitian"):
                off = rows != cols
                mirrored = vals[off]
                if symm == "skew-symmetric":
                    mirrored = -mirrored
                elif symm == "hermitian":
                    mirrored = np.conj(mirrored)
                rows = np.concatenate([rows, cols[off]])
                cols2 = np.concatenate(
                    [cols, data[off, 0].astype(np.int64) - 1])
                vals = np.concatenate([vals, mirrored])
                cols = cols2
            elif symm != "general":
                raise ValueError(f"unsupported symmetry {symm!r}")
            return CsrHost.from_coo(rows, cols, vals, (m, n),
                                    sum_duplicates=True)
        if fmt == "array":
            m, n = int(sizes[0]), int(sizes[1])
            if field == "complex":
                pairs = np.loadtxt(f, dtype=np.float64, ndmin=2)
                if symm != "general":
                    raise ValueError(
                        "complex array MatrixMarket: only 'general' "
                        "symmetry supported")
                vals = pairs[:, 0] + 1j * pairs[:, 1]
                return CsrHost.from_dense(vals.reshape((n, m)).T)
            vals = np.loadtxt(f, dtype=np.float64).reshape(-1)
            if symm == "symmetric":
                # file holds the lower triangle column-major (the reference
                # reshapes it to m×n first, which raises)
                full = np.zeros((m, n))
                k = 0
                for j in range(n):
                    cnt = m - j
                    full[j:, j] = vals[k:k + cnt]
                    k += cnt
                return CsrHost.from_dense(full + np.tril(full, -1).T)
            return CsrHost.from_dense(vals.reshape((n, m)).T)  # column-major
        raise ValueError(f"unsupported format {fmt!r}")
    finally:
        if should_close:
            f.close()


read_sparse.native_calls = 0
read_sparse.python_calls = 0


def read_dense(path_or_file) -> np.ndarray:
    """Read a MatrixMarket array file as a dense ndarray (RHS vectors)."""
    f, should_close = _open(path_or_file)
    try:
        header = f.readline()
        parts = header.strip().split()
        fmt = parts[2].lower()
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        sizes = line.split()
        m, n = int(sizes[0]), int(sizes[1])
        if fmt == "array":
            vals = np.loadtxt(f, dtype=np.float64).reshape(-1)
            return vals.reshape((n, m)).T
        raise ValueError("read_dense expects array format")
    finally:
        if should_close:
            f.close()


def write_sparse(path_or_file, a: CsrHost, comment: str = "") -> None:
    """Write host CSR as MatrixMarket coordinate real general
    (the Writer::writeSparseFile analogue)."""
    f, should_close = _open(path_or_file, "wt")
    try:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {a.nnz}\n")
        rows = np.repeat(np.arange(a.shape[0]), a.row_lengths())
        for r, c, v in zip(rows, a.cols, a.vals):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
    finally:
        if should_close:
            f.close()


def write_dense(path_or_file, x: np.ndarray, comment: str = "") -> None:
    f, should_close = _open(path_or_file, "wt")
    try:
        x = np.atleast_2d(np.asarray(x).T).T if x.ndim == 1 else x
        f.write("%%MatrixMarket matrix array real general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{x.shape[0]} {x.shape[1]}\n")
        for j in range(x.shape[1]):
            for i in range(x.shape[0]):
                f.write(f"{x[i, j]:.17g}\n")
    finally:
        if should_close:
            f.close()


def read_sparse_distributed(path_or_file, n_shards: int, fmt: str = "auto",
                            dtype=None):
    """Read and distribute the rows over ``n_shards`` ranks
    (MatrixMarket_Tpetra.hpp:1082-1148): the whole file is read — by every
    rank that calls this, each keeping its own part through
    ``DistMatrix.local`` — and partitioned by ``distribute``."""
    from ..parallel.distmatrix import distribute

    a = read_sparse(path_or_file)
    return distribute(a, n_shards, fmt=fmt, dtype=dtype)
