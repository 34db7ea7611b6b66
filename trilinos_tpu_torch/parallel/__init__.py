from .comm import (Comm, ProcessComm, ProcessGrid, SerialComm, dot,
                   fused_dots, norm2)
from . import dist_setup, distmatrix, driver, mdarray, partition
from .map import Directory, Map

__all__ = ["Comm", "Directory", "Map", "ProcessComm", "ProcessGrid",
           "SerialComm", "dist_setup", "distmatrix", "dot", "driver",
           "fused_dots", "mdarray", "norm2", "partition"]
