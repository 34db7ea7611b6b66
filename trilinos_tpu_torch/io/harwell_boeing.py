"""Harwell-Boeing (HB) sparse-matrix reader.

Counterpart of ``trilinos_tpu/io/harwell_boeing.py`` (the analogue of
``Tpetra::Utils::readHBMatrix``, Tpetra_MatrixIO_decl.hpp): host code,
copied. HB is Fortran fixed-format, column-compressed (CSC), 1-based:
  line 1: TITLE (A72), KEY (A8)
  line 2: TOTCRD PTRCRD INDCRD VALCRD RHSCRD (5I14)
  line 3: MXTYPE (A3), NROW NCOL NNZERO NELTVL (4I14)
  line 4: PTRFMT INDFMT VALFMT RHSFMT (2A16, 2A20)
  [line 5 when RHSCRD > 0: RHSTYP NRHS NRHSIX]
then column pointers, row indices, values in the declared Fortran edit
formats. Only assembled matrices (RUA/RSA/RZA/PUA/PSA…) are read.
"""
from __future__ import annotations

import re

import numpy as np

from ..ops.formats import CsrHost

_FMT_RE = re.compile(
    r"\(\s*(?:(\d+)\s*)?([IiEeDdFfGg])\s*(\d+)(?:\.(\d+))?\s*\)")


def _parse_fortran_format(fmt: str) -> tuple[int, int]:
    """Return (items_per_line, field_width) from e.g. '(16I5)', '(3E26.18)',
    '(1P5D16.9)' — scale factors and repeat groups are normalized away."""
    f = fmt.strip().upper().replace("1P", "").replace("0P", "")
    m = _FMT_RE.match(f)
    if not m:
        raise ValueError(f"unsupported Fortran format {fmt!r}")
    count = int(m.group(1)) if m.group(1) else 1
    width = int(m.group(3))
    return count, width


def _read_fixed(lines_iter, count_total: int, fmt: str, conv):
    per_line, width = _parse_fortran_format(fmt)
    out = []
    while len(out) < count_total:
        line = next(lines_iter).rstrip("\n")
        for k in range(per_line):
            s = line[k * width:(k + 1) * width]
            if not s.strip():
                continue
            out.append(conv(s.replace("D", "E").replace("d", "e")))
            if len(out) == count_total:
                break
    return out


def read_hb(path_or_file) -> CsrHost:
    if hasattr(path_or_file, "read"):
        f = path_or_file
        should_close = False
    else:
        f = open(path_or_file, "rt")
        should_close = True
    try:
        f.readline()  # title/key
        # header ints: nominally 14-wide fields, but many files in the wild
        # (incl. the reference's) truncate trailing blanks — parse leniently
        crd = f.readline().split()
        ptrcrd, indcrd = int(crd[1]), int(crd[2])
        valcrd = int(crd[3]) if len(crd) > 3 else 0
        rhscrd = int(crd[4]) if len(crd) > 4 else 0
        line3 = f.readline()
        mxtype = line3[:3].strip().upper()
        dims = line3[3:].split()
        nrow, ncol, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        line4 = f.readline()
        fmts = line4.split()
        ptrfmt = fmts[0]
        indfmt = fmts[1] if len(fmts) > 1 else ptrfmt
        valfmt = fmts[2] if len(fmts) > 2 else "(E20.12)"
        if rhscrd > 0:
            f.readline()  # RHS descriptor (RHS blocks themselves ignored)
        if len(mxtype) != 3 or mxtype[2] not in ("A",):
            raise ValueError(f"only assembled HB matrices supported, "
                             f"got type {mxtype!r}")
        it = iter(f)
        colptr = np.array(_read_fixed(it, ncol + 1, ptrfmt, int),
                          dtype=np.int64) - 1
        rowind = np.array(_read_fixed(it, nnz, indfmt, int),
                          dtype=np.int64) - 1
        if mxtype[0] == "P" or valcrd == 0:
            vals = np.ones(nnz)
        else:
            vals = np.array(_read_fixed(it, nnz, valfmt, float))
        # CSC -> COO
        cols = np.repeat(np.arange(ncol, dtype=np.int64),
                         np.diff(colptr))
        rows = rowind
        if mxtype[1] == "S":  # symmetric: lower triangle stored
            off = rows != cols
            rows_full = np.concatenate([rows, cols[off]])
            cols_full = np.concatenate([cols, rows[off]])
            vals_full = np.concatenate([vals, vals[off]])
            return CsrHost.from_coo(rows_full, cols_full, vals_full,
                                    (nrow, ncol), sum_duplicates=True)
        if mxtype[1] == "Z":  # skew-symmetric
            off = rows != cols
            rows_full = np.concatenate([rows, cols[off]])
            cols_full = np.concatenate([cols, rows[off]])
            vals_full = np.concatenate([vals, -vals[off]])
            return CsrHost.from_coo(rows_full, cols_full, vals_full,
                                    (nrow, ncol), sum_duplicates=True)
        return CsrHost.from_coo(rows, cols, vals, (nrow, ncol),
                                sum_duplicates=True)
    finally:
        if should_close:
            f.close()
