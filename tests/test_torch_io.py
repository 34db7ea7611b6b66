"""The port's host I/O against the JAX package's: Matrix Market,
Harwell-Boeing and the binary container.

Every file is written by the test itself (the reference's matrix suite is
not in the repository). Both packages read the same file and must give the
same CSR bit for bit (row pointers, columns, values), and the port's
native reader must give what its Python parser gives (coordinate files:
general, symmetric, skew-symmetric, pattern, integer, gzip, a header in
mixed case). The native header compares without regard to case and
declines a hermitian file to the Python parser, which mirrors it; the JAX
package's native reader reads both as general, so these two are held to
the JAX package's Python parser. Complex files and the array format take
the Python parser in both packages (a symmetric array file the port reads whole, where the
reference raises). A Harwell-Boeing RUA and RSA file that the test writes
in the reference's fixed Fortran formats read the same in both packages
and equal the matrix written to 1e-12 (12-digit E fields). Containers written by one
package read in the other. ``read_sparse_distributed`` waits for the
distributed layer.
"""
import gzip
import io

import numpy as np
import pytest

from trilinos_tpu import io as jio
from trilinos_tpu.galeri import laplace2d as j_laplace2d
from trilinos_tpu.galeri import recirc2d as j_recirc2d
from trilinos_tpu.ops import formats as JF

from trilinos_tpu_torch import io as tio
from trilinos_tpu_torch.io import matrix_market as tmm
from trilinos_tpu_torch.ops import formats as TF
from torch_threads import one_thread  # noqa: F401  (autouse)


def port_csr(a):
    return TF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape)


def same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)


def python_read(path):
    """The port's Python parser on ``path`` (a file object is never given
    to the native reader)."""
    with open(path) as f:
        return tio.read_sparse(f)


MATRICES = {"laplace2d": j_laplace2d(7, 9),
            "recirc2d": j_recirc2d(9, 6, diff=1e-3)}

# coordinate files the native parser takes: (header, size line, entries)
COORD_FILES = {
    "symmetric": ("coordinate real symmetric", "3 3 4",
                  ["1 1 2.0", "2 1 -1.0", "2 2 2.0", "3 3 5.0"]),
    "skew": ("coordinate real skew-symmetric", "3 3 2",
             ["2 1 1.5", "3 2 -0.25"]),
    "pattern": ("coordinate pattern general", "2 3 3",
                ["1 1", "2 2", "1 3"]),
    "integer": ("coordinate integer general", "3 3 3",
                ["1 1 4", "3 1 -2", "2 3 7"]),
    "duplicates": ("coordinate real general", "2 2 3",
                   ["1 1 0.5", "1 1 0.25", "2 2 1e-300"]),
    "Symmetric": ("coordinate real Symmetric", "3 3 4",
                  ["1 1 2.0", "2 1 -1.0", "2 2 2.0", "3 3 5.0"]),
    "hermitian": ("coordinate real hermitian", "3 3 4",
                  ["1 1 2.0", "2 1 -1.0", "2 2 2.0", "3 3 5.0"]),
}
# headers the JAX package's native reader reads as general (it compares
# case-sensitively and does not mirror hermitian): held to its Python
# parser, and the native path of the port declines hermitian
JAX_NATIVE_GENERAL = {"Symmetric": "native", "hermitian": "python"}


def write_text(path, header, size, entries, comment="generated"):
    path.write_text(f"%%MatrixMarket matrix {header}\n% {comment}\n{size}\n"
                    + "\n".join(entries) + "\n")
    return path


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_round_trip_both_packages(tmp_path, name):
    a = MATRICES[name]
    t_path, j_path = tmp_path / "port.mtx", tmp_path / "jax.mtx"
    tio.write_sparse(t_path, port_csr(a), comment=f"{name}\nsecond line")
    jio.write_sparse(str(j_path), a, comment=f"{name}\nsecond line")
    assert t_path.read_text() == j_path.read_text()
    before = (tmm.read_sparse.native_calls, tmm.read_sparse.python_calls)
    got = tio.read_sparse(t_path)
    assert (tmm.read_sparse.native_calls,
            tmm.read_sparse.python_calls) == (before[0] + 1, before[1])
    same_csr(got, jio.read_sparse(str(t_path)))
    same_csr(got, a)
    same_csr(python_read(t_path), a)
    buf = io.StringIO()
    tio.write_sparse(buf, port_csr(a))
    buf.seek(0)
    same_csr(tio.read_sparse(buf), a)


@pytest.mark.parametrize("kind", sorted(COORD_FILES))
def test_native_reader_matches_python_and_jax(tmp_path, kind):
    path = write_text(tmp_path / f"{kind}.mtx", *COORD_FILES[kind])
    before = (tmm.read_sparse.native_calls, tmm.read_sparse.python_calls)
    native = tio.read_sparse(path)
    served = "python" if JAX_NATIVE_GENERAL.get(kind) == "python" \
        else "native"
    assert (tmm.read_sparse.native_calls - before[0],
            tmm.read_sparse.python_calls - before[1]) == (
        (1, 0) if served == "native" else (0, 1))
    same_csr(native, python_read(path))
    if kind in JAX_NATIVE_GENERAL:
        with open(path) as f:
            same_csr(native, jio.read_sparse(f))
        assert native.nnz == 5  # (2, 1) mirrored to (1, 2)
    else:
        same_csr(native, jio.read_sparse(str(path)))
    gz = tmp_path / f"{kind}.mtx.gz"
    with gzip.open(gz, "wb") as f:
        f.write(path.read_bytes())
    same_csr(tio.read_sparse(gz), native)
    if kind == "skew":
        d = native.to_dense()
        np.testing.assert_array_equal(d, -d.T)


def test_reader_without_the_native_library(tmp_path, monkeypatch):
    a = MATRICES["recirc2d"]
    path = tmp_path / "a.mtx"
    tio.write_sparse(path, port_csr(a))
    monkeypatch.setattr(tmm, "read_mm_native", lambda p: None)
    before = tmm.read_sparse.python_calls
    same_csr(tio.read_sparse(path), a)
    assert tmm.read_sparse.python_calls == before + 1


@pytest.mark.parametrize("text", [
    """%%MatrixMarket matrix coordinate complex general
3 3 4
1 1 2.0 1.0
2 2 3.0 -0.5
3 3 4.0 0.0
1 3 0.5 0.25
""", """%%MatrixMarket matrix coordinate complex hermitian
2 2 3
1 1 2.0 0.0
2 2 3.0 0.0
2 1 1.0 0.5
""", """%%MatrixMarket matrix array complex general
2 2
1.0 0.5
2.0 0.0
3.0 -1.0
4.0 0.25
""", """%%MatrixMarket matrix array real symmetric
3 3
4.0
-1.0
0.5
3.0
-2.0
5.0
"""], ids=["complex", "hermitian", "complex-array", "symmetric-array"])
def test_python_parser_files_match_jax(tmp_path, text):
    path = tmp_path / "z.mtx"
    path.write_text(text)
    got = tio.read_sparse(path)
    if "symmetric" in text:
        # the reference reshapes the stored lower triangle to m×n before
        # its symmetric branch and raises; the port reads the full matrix
        with pytest.raises(ValueError, match="reshape"):
            jio.read_sparse(str(path))
        np.testing.assert_array_equal(got.to_dense(), [[4.0, -1.0, 0.5],
                                                       [-1.0, 3.0, -2.0],
                                                       [0.5, -2.0, 5.0]])
        return
    same_csr(got, jio.read_sparse(str(path)))
    if "complex" in text:
        assert got.vals.dtype.kind == "c"
    if "hermitian" in text:
        d = got.to_dense()
        assert d[1, 0] == 1.0 + 0.5j and d[0, 1] == 1.0 - 0.5j


def test_dense_round_trip_both_packages():
    x = np.random.default_rng(4).standard_normal((5, 3))
    t_buf, j_buf = io.StringIO(), io.StringIO()
    tio.write_dense(t_buf, x, comment="x")
    jio.write_dense(j_buf, x, comment="x")
    assert t_buf.getvalue() == j_buf.getvalue()
    t_buf.seek(0)
    j_buf.seek(0)
    np.testing.assert_array_equal(tio.read_dense(t_buf), x)
    np.testing.assert_array_equal(jio.read_dense(j_buf), x)


def test_bad_header_and_distributed_read_raise(tmp_path):
    with pytest.raises(ValueError):
        tio.read_sparse(io.StringIO("garbage\n1 1 1\n"))
    path = tmp_path / "bad.mtx"
    path.write_text("garbage\n1 1 1\n")
    with pytest.raises(ValueError):
        tio.read_sparse_distributed(path, 2)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_read_sparse_distributed_matches_jax(tmp_path, n_shards):
    """Every rank's host arrays of the distributed read (plan, boundary,
    interior) are the JAX package's shard arrays."""
    path = tmp_path / "r.mtx"
    jio.write_sparse(str(path), j_recirc2d(9, 7))
    got = tio.read_sparse_distributed(str(path), n_shards)
    want = jio.read_sparse_distributed(str(path), n_shards)
    assert got.plan.mode == want.plan.mode
    for part, fields in ((got.plan, ("send_idx", "send_valid", "recv_sel",
                                     "ghost_valid")),
                         (got.boundary, ("rows_idx", "cols", "vals"))):
        jpart = want.plan if part is got.plan else want.boundary
        for f in fields:
            np.testing.assert_array_equal(getattr(part, f),
                                          np.asarray(getattr(jpart, f)))
    data = np.asarray(want.interior.data)
    for s in range(n_shards):
        assert got.interior[s].offsets == want.interior.offsets
        np.testing.assert_array_equal(got.interior[s].data.numpy(),
                                      data[s].reshape(data.shape[1], -1))


def write_hb(path, a, mxtype):
    """Harwell-Boeing file of host CSR ``a`` (column-compressed, 1-based)
    in the reference's fixed formats: pointers and indices (8I10), values
    (4E20.12); for a symmetric type only the lower triangle is stored."""
    csc = JF.CsrHost(a.row_ptr, a.cols, a.vals, a.shape).transpose()
    rows = np.repeat(np.arange(csc.shape[0]), csc.row_lengths())
    keep = (np.ones(csc.nnz, bool) if mxtype[1] == "U"
            else csc.cols >= rows)  # stored column rows[i], row cols[i]
    cptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows[keep], minlength=csc.shape[0]))]) + 1
    rind = csc.cols[keep] + 1
    vals = csc.vals[keep]

    def lines(items, per, fmt):
        return ["".join(fmt(v) for v in items[i:i + per])
                for i in range(0, len(items), per)]

    ptr_l = lines(cptr, 8, lambda v: f"{v:10d}")
    ind_l = lines(rind, 8, lambda v: f"{v:10d}")
    val_l = lines(vals, 4, lambda v: f"{v:20.12E}")
    tot = len(ptr_l) + len(ind_l) + len(val_l)
    head = [f"{'generated test matrix':<72}{'KEY':<8}",
            f"{tot:14d}{len(ptr_l):14d}{len(ind_l):14d}{len(val_l):14d}"
            f"{0:14d}",
            f"{mxtype:<14}{a.shape[0]:14d}{a.shape[1]:14d}{len(vals):14d}"
            f"{0:14d}",
            f"{'(8I10)':<16}{'(8I10)':<16}{'(4E20.12)':<20}{'':<20}"]
    path.write_text("\n".join(head + ptr_l + ind_l + val_l) + "\n")
    return path


@pytest.mark.parametrize("mxtype,name", [("RUA", "recirc2d"),
                                         ("RSA", "laplace2d")])
def test_harwell_boeing_reads_like_jax(tmp_path, mxtype, name):
    a = MATRICES[name]
    path = write_hb(tmp_path / f"{name}.hb", a, mxtype)
    got = tio.read_hb(str(path))
    same_csr(got, jio.read_hb(str(path)))
    np.testing.assert_allclose(got.to_dense(), a.to_dense(), rtol=1e-12,
                               atol=0)
    with open(path) as f:
        same_csr(tio.read_hb(f), got)


def test_harwell_boeing_refuses_elemental(tmp_path):
    path = write_hb(tmp_path / "e.hb", MATRICES["laplace2d"], "RUA")
    text = path.read_text().splitlines()
    text[2] = "RUE" + text[2][3:]
    path.write_text("\n".join(text) + "\n")
    for read in (tio.read_hb, jio.read_hb):
        with pytest.raises(ValueError, match="assembled"):
            read(str(path))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_container_across_packages(tmp_path, writer):
    a = MATRICES["recirc2d"]
    vec = np.random.default_rng(5).standard_normal(17)
    w_io, r_io = (tio, jio) if writer == "port" else (jio, tio)
    csr = port_csr(a) if writer == "port" else a
    path = str(tmp_path / "c.ttbc")
    (w_io.BinaryContainer().add_csr("A", csr).add_array("x", vec)
     .add_coo("B", [0, 1, 2], [2, 1, 0], [1.5, -2.0, 3.25], (3, 3))
     .add_meta("info", {"solver": "GMRES", "rtol": 1e-8}).write(path))
    c = r_io.BinaryContainer.open(path)
    assert c.names() == ["A", "B", "info", "x"]
    same_csr(c.get_csr("A"), a)
    np.testing.assert_array_equal(c.get_array("x"), vec)
    r, cc, v, shape = c.get_coo("B")
    np.testing.assert_array_equal(cc, [2, 1, 0])
    np.testing.assert_array_equal(v, [1.5, -2.0, 3.25])
    assert shape == (3, 3) and c.get_meta("info")["solver"] == "GMRES"
    csr_path, coo_path = str(tmp_path / "a.csr"), str(tmp_path / "m.coo")
    w_io.write_csr(csr_path, csr, origin="test")
    same_csr(r_io.read_csr(csr_path), a)
    w_io.write_coo(coo_path, np.array([0, 5]), np.array([1, 3]),
                   np.array([2.0, -4.0]), (6, 6))
    r, cc, v, shape = r_io.read_coo(coo_path)
    np.testing.assert_array_equal(r, [0, 5])
    assert shape == (6, 6)
    bad = tmp_path / "junk.bin"
    bad.write_bytes(b"NOTTTBC!xxxx")
    with pytest.raises(ValueError):
        tio.BinaryContainer.open(str(bad))
