from .lanczos import arnoldi, lanczos_eigs

__all__ = ["arnoldi", "lanczos_eigs"]
