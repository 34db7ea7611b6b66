from .comm import (Comm, ProcessComm, SerialComm, dot, fused_dots, norm2)
from . import dist_setup, distmatrix, driver, partition
from .map import Directory, Map

__all__ = ["Comm", "Directory", "Map", "ProcessComm", "SerialComm",
           "dist_setup", "distmatrix", "dot", "driver", "fused_dots",
           "norm2", "partition"]
