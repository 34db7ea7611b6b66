"""Host I/O: Matrix Market, Harwell-Boeing and the binary container.

Counterpart of ``trilinos_tpu/io`` but ``vtk.py``, which waits for the
``fem/`` layer (ROADMAP.md queue 1 item 11).
"""
from .container import (BinaryContainer, OpenContainer, read_coo, read_csr,
                        write_coo, write_csr)
from .harwell_boeing import read_hb
from .matrix_market import (read_dense, read_sparse, read_sparse_distributed,
                            write_dense, write_sparse)

__all__ = ["BinaryContainer", "OpenContainer", "read_coo", "read_csr",
           "read_dense", "read_hb", "read_sparse", "read_sparse_distributed",
           "write_coo", "write_csr", "write_dense", "write_sparse"]
