"""Binary multi-object container and binary COO matrix I/O.

Counterpart of ``trilinos_tpu/io/container.py``: host code, copied. A
single-file container of named objects (the role of EpetraExt's HDF5
container, EpetraExt_HDF5.h): an 8-byte magic, a JSON index, then
64-byte-aligned raw array blobs, read back as numpy memmaps. ``write_coo``/
``read_coo`` store (rows, cols, vals) triplets with their dtypes (the role
of Tpetra_Details_CooMatrix.hpp).
"""
from __future__ import annotations

import json
import struct

import numpy as np

from ..ops.formats import CsrHost

_MAGIC = b"TTBC0001"
_ALIGN = 64


def _tolist(x):
    return [int(v) for v in x]


class BinaryContainer:
    """Named-object store: CsrHost matrices, ndarrays, COO triples,
    JSON-able metadata dicts."""

    def __init__(self):
        self._objs: dict[str, tuple[str, object]] = {}

    # -- writers ----------------------------------------------------------
    def add_array(self, name: str, arr: np.ndarray) -> "BinaryContainer":
        self._objs[name] = ("array", np.ascontiguousarray(arr))
        return self

    def add_csr(self, name: str, a: CsrHost) -> "BinaryContainer":
        self._objs[name] = ("csr", a)
        return self

    def add_coo(self, name: str, rows, cols, vals,
                shape) -> "BinaryContainer":
        self._objs[name] = ("coo", (np.asarray(rows), np.asarray(cols),
                                    np.asarray(vals), tuple(shape)))
        return self

    def add_meta(self, name: str, meta: dict) -> "BinaryContainer":
        self._objs[name] = ("meta", dict(meta))
        return self

    def write(self, path: str) -> None:
        index = {}
        blobs: list[np.ndarray] = []

        def put(arr):
            blobs.append(np.ascontiguousarray(arr))
            return len(blobs) - 1

        for name, (kind, obj) in self._objs.items():
            if kind == "array":
                index[name] = dict(kind=kind, dtype=str(obj.dtype),
                                   shape=_tolist(obj.shape), blob=put(obj))
            elif kind == "csr":
                index[name] = dict(
                    kind=kind, shape=_tolist(obj.shape),
                    vdtype=str(obj.vals.dtype),
                    row_ptr=put(obj.row_ptr), cols=put(obj.cols),
                    vals=put(obj.vals))
            elif kind == "coo":
                r, c, v, shape = obj
                index[name] = dict(
                    kind=kind, shape=_tolist(shape),
                    idtype=str(r.dtype), vdtype=str(v.dtype),
                    rows=put(r), cols=put(c), vals=put(v))
            elif kind == "meta":
                index[name] = dict(kind=kind, meta=obj)
        # layout: magic | u64 index_len | index json | aligned blobs
        head = json.dumps(dict(objects=index)).encode()
        offset = len(_MAGIC) + 8 + len(head)
        blob_meta = []
        for b in blobs:
            offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
            blob_meta.append(dict(offset=offset, nbytes=int(b.nbytes),
                                  dtype=str(b.dtype),
                                  shape=_tolist(b.shape)))
            offset += b.nbytes
        head = json.dumps(dict(objects=index, blobs=blob_meta)).encode()
        # head size changed -> recompute offsets once more (fixed point:
        # pad head to a stable length)
        head_len = len(head) + 64
        head = head + b" " * (head_len - len(head))
        offset = len(_MAGIC) + 8 + head_len
        for bm, b in zip(blob_meta, blobs):
            offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
            bm["offset"] = offset
            offset += b.nbytes
        head = json.dumps(dict(objects=index, blobs=blob_meta)).encode()
        assert len(head) <= head_len
        head = head + b" " * (head_len - len(head))
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", head_len))
            f.write(head)
            for bm, b in zip(blob_meta, blobs):
                f.seek(bm["offset"])
                f.write(b.tobytes())

    # -- readers ----------------------------------------------------------
    @classmethod
    def open(cls, path: str) -> "OpenContainer":
        return OpenContainer(path)


class OpenContainer:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a TTBC container")
            (head_len,) = struct.unpack("<Q", f.read(8))
            head = json.loads(f.read(head_len).decode())
        self._index = head["objects"]
        self._blobs = head["blobs"]

    def names(self):
        return sorted(self._index)

    def kind(self, name: str) -> str:
        return self._index[name]["kind"]

    def _blob(self, i: int) -> np.ndarray:
        bm = self._blobs[i]
        return np.memmap(self.path, mode="r", dtype=np.dtype(bm["dtype"]),
                         offset=bm["offset"],
                         shape=tuple(bm["shape"]))

    def get_array(self, name: str) -> np.ndarray:
        e = self._index[name]
        assert e["kind"] == "array", name
        return self._blob(e["blob"])

    def get_csr(self, name: str) -> CsrHost:
        e = self._index[name]
        assert e["kind"] == "csr", name
        return CsrHost(np.asarray(self._blob(e["row_ptr"])),
                       np.asarray(self._blob(e["cols"])),
                       np.asarray(self._blob(e["vals"])),
                       tuple(e["shape"]))

    def get_coo(self, name: str):
        e = self._index[name]
        assert e["kind"] == "coo", name
        return (np.asarray(self._blob(e["rows"])),
                np.asarray(self._blob(e["cols"])),
                np.asarray(self._blob(e["vals"])), tuple(e["shape"]))

    def get_meta(self, name: str) -> dict:
        e = self._index[name]
        assert e["kind"] == "meta", name
        return e["meta"]


def write_coo(path: str, rows, cols, vals, shape) -> None:
    """Standalone binary COO file (Tpetra_Details_CooMatrix analogue)."""
    BinaryContainer().add_coo("coo", rows, cols, vals, shape).write(path)


def read_coo(path: str):
    return BinaryContainer.open(path).get_coo("coo")


def write_csr(path: str, a: CsrHost, **meta) -> None:
    c = BinaryContainer().add_csr("matrix", a)
    if meta:
        c.add_meta("meta", meta)
    c.write(path)


def read_csr(path: str) -> CsrHost:
    return BinaryContainer.open(path).get_csr("matrix")
