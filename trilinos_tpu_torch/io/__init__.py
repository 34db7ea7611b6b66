"""Host I/O: Matrix Market, Harwell-Boeing, the binary container and legacy
VTK meshes.

Counterpart of ``trilinos_tpu/io``.
"""
from .container import (BinaryContainer, OpenContainer, read_coo, read_csr,
                        write_coo, write_csr)
from .harwell_boeing import read_hb
from .matrix_market import (read_dense, read_sparse, read_sparse_distributed,
                            write_dense, write_sparse)
from .vtk import read_vtk, write_vtk, write_vtk_series

__all__ = ["BinaryContainer", "OpenContainer", "read_coo", "read_csr",
           "read_dense", "read_hb", "read_sparse", "read_sparse_distributed",
           "read_vtk", "write_coo", "write_csr", "write_dense",
           "write_sparse", "write_vtk", "write_vtk_series"]
