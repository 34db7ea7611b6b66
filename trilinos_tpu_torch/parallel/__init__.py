from .comm import Comm, SerialComm

__all__ = ["Comm", "SerialComm"]
