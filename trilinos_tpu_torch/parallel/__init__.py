from .comm import Comm, SerialComm, norm2

__all__ = ["Comm", "SerialComm", "norm2"]
