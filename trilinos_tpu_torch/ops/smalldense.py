"""Small dense factorizations (k ≤ 32) for the solvers' hot loops.

Counterpart of ``trilinos_tpu/ops/smalldense.py`` (the role of the small
Teuchos::LAPACK calls inside the Belos/Anasazi managers). CholQR needs the
Cholesky factor of a k×k Gram matrix and its inverse, so that the (n, k)
triangular solve becomes one GEMM ``w @ L⁻ᵀ``.

Kernel: ``csrc/chol_inv_small.cu`` replaces the TPU kernel
``chol_inv_small`` (``_chol_inv_kernel``): (L, L⁻¹) in one launch, where
the plain version (:func:`chol_inv_small_plain`, the unrolled
:func:`chol_small` + :func:`tri_inv_small` pair) is about 2k dependent
small operations. Its work is a few kilobytes and a few thousand flops:
one warp holds g's rows in registers and broadcasts by shuffle, so its
device time is a launch plus a chain of one multiply-add, two shuffles and
an rsqrt a column. The plain version's matvecs sum in the BLAS's order, so
kernel and plain version agree to a tolerance, not to the bit.

For k > ``UNROLL_MAX`` both functions use ``torch.linalg.cholesky`` and
``torch.linalg.solve_triangular`` on every device, as the JAX package uses
its library primitives there. The path is chosen from the tensor's device,
not from a default backend.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .dispatch import use_kernel

UNROLL_MAX = 32  # csrc/chol_inv_small.cu TT_MAX_K

_P = ctypes.c_void_p
_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_SIGS = {**{f"chol_inv_small_{t}": [_P, _P, _P, ctypes.c_int, _P]
            for t in _TYPES.values()},
         "empty_launch": [_P]}


def chol_small(g: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a small SPD matrix (unrolled k ≤ 32; no
    floor added: callers keep their own regularisation). Column j is
    s = g[:, j] − L·L[j, :] scaled by rsqrt(s[j])."""
    k = g.shape[0]
    if k > UNROLL_MAX:
        return torch.linalg.cholesky(g)
    l = torch.zeros_like(g)
    rows = torch.arange(k, device=g.device)
    for j in range(k):
        # s[i] = g[i,j] − Σ_{p<j} l[i,p]·l[j,p]  (columns ≥ j still zero)
        s = g[:, j] - l @ l[j, :]
        col = s * torch.rsqrt(s[j])
        l[:, j] = torch.where(rows >= j, col, 0.0)
    return l


def tri_inv_small(r: torch.Tensor, *, lower: bool = False) -> torch.Tensor:
    """Inverse of a small triangular matrix (unrolled k ≤ 32): row
    substitution on R·X = I, one (k,)@(k,k) product per row."""
    k = r.shape[0]
    eye = torch.eye(k, dtype=r.dtype, device=r.device)
    if k > UNROLL_MAX:
        return torch.linalg.solve_triangular(r, eye, upper=not lower)
    x = torch.zeros_like(r)
    for i in (range(k) if lower else reversed(range(k))):
        # R[i,i]·X[i,:] = e_i − Σ_{m≠i} R[i,m]·X[m,:]  (unset rows zero)
        x[i, :] = (eye[i] - r[i, :] @ x) / r[i, i]
    return x


def chol_inv_small_plain(g: torch.Tensor):
    """Plain (L, L⁻¹) of a small SPD matrix."""
    l = chol_small(g)
    return l, tri_inv_small(l, lower=True)


def _launch(g: torch.Tensor):
    """Checks, then one launch of ``chol_inv_small_<type>``."""
    if g.dtype not in _TYPES:
        raise TypeError(f"chol_inv_small kernel takes float32/float64, got "
                        f"{g.dtype}")
    g = g.contiguous()
    lib = _build.load("chol_inv_small", _SIGS)
    l = torch.empty_like(g)
    linv = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"chol_inv_small_{_TYPES[g.dtype]}")(
            g.data_ptr(), l.data_ptr(), linv.data_ptr(), g.shape[0], stream)
    _build.check(lib, rc, "chol_inv_small")
    return l, linv


def chol_inv_small(g: torch.Tensor):
    """(L, L⁻¹) of a small SPD g with g = L·Lᵀ: the CUDA kernel for a CUDA
    tensor with k ≤ 32, the plain version for a CPU tensor, the library
    pair for k > 32. ``chol_inv_small.launches`` counts kernel launches.
    Callers wanting R = Lᵀ factors use ``rinv = linv.T``."""
    if g.ndim != 2 or g.shape[0] != g.shape[1]:
        raise ValueError(f"chol_inv_small takes a square matrix, got "
                         f"{tuple(g.shape)}")
    if g.shape[0] > UNROLL_MAX or not use_kernel(g):
        return chol_inv_small_plain(g)
    out = _launch(g)
    chol_inv_small.launches += 1
    return out


chol_inv_small.launches = 0


def empty_launch(device) -> None:
    """Launch the source's empty kernel on ``device``: the launch floor
    beside which ``chol_inv_small``'s time is read."""
    lib = _build.load("chol_inv_small", _SIGS)
    with torch.cuda.device(device):
        rc = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "empty_launch")


def chol_solve_small(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """g⁻¹·rhs for a small SPD g through the fused factor (no floor
    added)."""
    _, linv = chol_inv_small(g)
    return linv.T @ (linv @ rhs)
