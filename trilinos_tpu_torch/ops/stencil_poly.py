"""Stencil polynomial: a chain of three-term stages on a ``StencilOp``.

Counterpart of ``trilinos_tpu/ops/pallas/stencil_poly.py``. With u_0 = x,

    u_j = α_j·(A u_{j−1}) + β_j·u_{j−1} + γ_j·u_{j−2} + ζ_j·x   (j = 1..s)

expresses Chebyshev smoothing (:func:`chebyshev_stages`), damped-Jacobi /
Richardson sweeps (:func:`richardson_stages`), plain powers and the
σ-scaled monomial or Newton Krylov bases of s-step GMRES.
:func:`stencil_poly_apply` returns u_s, :func:`stencil_powers_apply` the
(s, n_pad) stack of u_1..u_s. Pad rows carry u_{j−1} (hence x) through
every stage. ``z_bounds`` = (z_lo, z_hi) narrows the planes a neighbour
may lie on (default (0, nz)) for every term, as the JAX package's XLA
reference ``_spmv_xla_zb`` does; its Pallas kernel masks only the terms
with dz ≠ 0, so on rows whose own plane lies outside [z_lo, z_hi) this
module (plain version and kernel alike) follows the XLA reference.

Kernel: ``csrc/stencil_poly.cu`` replaces the TPU kernel ``_poly_call``
(``_poly_kernel``, ``_stage_strip``). One launch per stage, one thread per
grid point; each stage is bitwise the plain version's (same term order,
zero coefficients skipped, no fused multiply-add). Its bound is the fused
traffic, (1 + n_out)·n·itemsize over 3.35 TB/s; launching stage by stage
it moves about three vectors a stage, so it sits above that bound until
the single-pass redesign (temporal blocking along z) lands.
``stencil_poly_apply.launches`` and ``stencil_powers_apply.launches``
count applies; their ``.stage_launches`` count the stage kernels those
applies launched (s each).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .dispatch import use_kernel
from .matvec import spmv
from .stencil_op import (MAX_GRID_YZ, MAX_TERMS, StencilOp, _terms,
                         stencil_spmv_plain)

MAX_STAGES = 8  # csrc/stencil_poly.cu TT_MAX_STAGES

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIG = [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
        _P, _I, _P]
_TYPES = {torch.float32: "f32", torch.float64: "f64"}


# -- stage builders -----------------------------------------------------------

def chebyshev_stages(lmax: float, lmin: float, degree: int, dinv: float):
    """Stages reproducing the Chebyshev semi-iteration (Saad Alg. 12.1) on
    the Jacobi-scaled system with constant diagonal 1/dinv and a zero
    initial guess."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    stages = [(0.0, 0.0, 0.0, dinv / theta)]   # x_1 = D⁻¹ b / θ
    for j in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        rr = rho_new * rho
        w = 2.0 * rho_new / delta * dinv
        # x_{j+1} = −w A x_j + (1 + rr) x_j − rr x_{j−1} + w b
        gamma = 0.0 if j == 0 else -rr         # x_0 = 0 kills the term
        stages.append((-w, 1.0 + rr, gamma, w))
        rho = rho_new
    return tuple(stages)


def stencil_chebyshev_setup(op: StencilOp, degree: int,
                            lmax: float | None = None,
                            lmin: float | None = None, ratio: float = 30.0,
                            boost: float = 1.1, eig_iters: int = 10,
                            device=None):
    """Stage coefficients of a degree-``degree`` Chebyshev smoother on a
    stencil with a constant diagonal. Without ``lmax``, λmax(D⁻¹A) comes
    from ``eig_iters`` float32 power iterations from a seed-0 normal
    vector over the padded rows, times ``boost``, on ``device`` (``None``
    means the CUDA card); ``lmin`` defaults to lmax / ratio."""
    center = [c for o3, c in zip(op.offsets, op.coeffs) if o3 == (0, 0, 0)]
    if not center or center[0] == 0.0:
        raise ValueError("stencil has no (constant) diagonal term")
    dinv = 1.0 / center[0]
    if lmax is None:
        v = torch.as_tensor(np.random.default_rng(0).standard_normal(
            op.n_rows_pad), dtype=torch.float32).to(resolve_device(device))
        v = v / torch.linalg.vector_norm(v)
        lam = 1.0
        for _ in range(eig_iters):
            w = dinv * spmv(op, v)
            lam = float(torch.linalg.vector_norm(w))
            v = w / max(lam, 1e-30)
        lmax = lam * boost
    if lmin is None:
        lmin = lmax / ratio
    return chebyshev_stages(float(lmax), float(lmin), degree, dinv)


def power_stages(s: int):
    """u_s = A^s x."""
    return tuple((1.0, 0.0, 0.0, 0.0) for _ in range(s))


def monomial_stages(s: int, sigma: float = 1.0):
    """σ-scaled monomial Krylov basis: u_j = (A u_{j−1})/σ."""
    inv = 1.0 / float(sigma)
    return tuple((inv, 0.0, 0.0, 0.0) for _ in range(s))


def richardson_stages(omega: float, s: int, dinv: float):
    """Damped-Jacobi sweeps on A x = b from x_0 = 0:
    x_{j+1} = x_j + ω D⁻¹ (b − A x_j)."""
    w = omega * dinv
    stages = [(0.0, 0.0, 0.0, w)]
    for _ in range(s - 1):
        stages.append((-w, 1.0, 0.0, w))
    return tuple(stages)


# Newton-basis stages live with their consumer:
# solvers.sstep_gmres.newton_basis_stages (append a 0.0 zeta).


# -- plain versions -----------------------------------------------------------

def _poly_plain(op: StencilOp, stages, x: torch.Tensor, z_bounds):
    pad = torch.arange(op.n_rows_pad, device=x.device) >= op.n_rows
    u_prev2 = torch.zeros_like(x)
    u_prev = x
    outs = []
    for a, bt, g, z in stages:
        u = torch.zeros_like(x)
        if a:
            u = a * stencil_spmv_plain(op, u_prev, z_bounds)
        if bt:
            u = u + bt * u_prev
        if g:
            u = u + g * u_prev2
        if z:
            u = u + z * x
        u = torch.where(pad, u_prev, u)
        u_prev2, u_prev = u_prev, u
        outs.append(u)
    return outs


def stencil_poly_plain(op: StencilOp, stages, x: torch.Tensor,
                       z_bounds=None) -> torch.Tensor:
    """Plain PyTorch u_s (any device, any float dtype)."""
    return _poly_plain(op, stages, x, z_bounds)[-1]


def stencil_powers_plain(op: StencilOp, stages, x: torch.Tensor,
                         z_bounds=None) -> torch.Tensor:
    """Plain PyTorch (s, n_pad) stack of u_1..u_s."""
    return torch.stack(_poly_plain(op, stages, x, z_bounds))


# -- kernel wrappers ----------------------------------------------------------

def _validate(op: StencilOp, stages, x: torch.Tensor, z_bounds):
    """Stages as float 4-tuples and the (z_lo, z_hi) pair, after the checks
    both wrappers share on every device."""
    stages = tuple((float(a), float(bt), float(g), float(z))
                   for a, bt, g, z in stages)
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"stencil polynomial takes 1..{MAX_STAGES} stages, "
                         f"got {len(stages)}")
    if stages[0][2] != 0.0:
        raise ValueError("gamma_1 must be 0 (u_{-1} does not exist)")
    nz = op.dims[2]
    z_lo, z_hi = (0, nz) if z_bounds is None else (int(z_bounds[0]),
                                                    int(z_bounds[1]))
    if not 0 <= z_lo <= z_hi <= nz:
        raise ValueError(f"z_bounds ({z_lo}, {z_hi}) outside 0 ≤ z_lo ≤ "
                         f"z_hi ≤ nz = {nz}")
    if x.ndim != 1 or x.shape[0] != op.n_rows_pad:
        raise ValueError(f"stencil polynomial takes x of shape "
                         f"({op.n_rows_pad},), got {tuple(x.shape)}")
    return stages, (z_lo, z_hi)


def _launch(op: StencilOp, stages, x: torch.Tensor, z_bounds,
            all_outputs: bool) -> torch.Tensor:
    """One call of ``stencil_poly_<type>``: s stage launches on the current
    stream."""
    if x.dtype not in _TYPES:
        raise TypeError(f"stencil polynomial kernel takes float32/float64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stencil polynomial kernel takes a contiguous x")
    nx, ny, nz = op.dims
    if len(op.offsets) > MAX_TERMS or ny > MAX_GRID_YZ or nz > MAX_GRID_YZ:
        raise ValueError(f"stencil polynomial kernel takes ≤ {MAX_TERMS} "
                         f"terms and ny, nz ≤ {MAX_GRID_YZ}")
    lib = _build.load("stencil_poly", {f"stencil_poly_{t}": _SIG
                                       for t in _TYPES.values()})
    dx, dy, dz, lin, c = _terms(op)
    s = len(stages)
    coeffs = np.asarray(stages, dtype=np.float64).reshape(-1)
    npad = op.n_rows_pad
    out = torch.empty((s, npad) if all_outputs else (npad,), dtype=x.dtype,
                      device=x.device)
    scratch = None if all_outputs or s == 1 else torch.empty(
        (min(s - 1, 3), npad), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"stencil_poly_{_TYPES[x.dtype]}")(
            x.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), op.n_rows, npad,
            nx, ny, nz, z_bounds[0], z_bounds[1], len(op.offsets),
            dx.ctypes.data, dy.ctypes.data, dz.ctypes.data, lin.ctypes.data,
            c.ctypes.data, s, coeffs.ctypes.data, int(all_outputs), stream)
    _build.check(lib, rc, "stencil_poly")
    return out


def stencil_poly_apply(op: StencilOp, stages, x: torch.Tensor,
                       z_bounds=None) -> torch.Tensor:
    """u_s of the stage chain ``stages`` ((α, β, γ, ζ) per stage, 1 ≤ s ≤ 8,
    γ_1 = 0) for x of shape (n_pad,): the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    stages, zb = _validate(op, stages, x, z_bounds)
    if not use_kernel(x):
        return stencil_poly_plain(op, stages, x, zb)
    y = _launch(op, stages, x, zb, all_outputs=False)
    stencil_poly_apply.launches += 1
    stencil_poly_apply.stage_launches += len(stages)
    return y


def stencil_powers_apply(op: StencilOp, stages, x: torch.Tensor,
                         z_bounds=None) -> torch.Tensor:
    """The (s, n_pad) stack [u_1; …; u_s] (the matrix-powers basis): the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    stages, zb = _validate(op, stages, x, z_bounds)
    if not use_kernel(x):
        return stencil_powers_plain(op, stages, x, zb)
    y = _launch(op, stages, x, zb, all_outputs=True)
    stencil_powers_apply.launches += 1
    stencil_powers_apply.stage_launches += len(stages)
    return y


stencil_poly_apply.launches = stencil_poly_apply.stage_launches = 0
stencil_powers_apply.launches = stencil_powers_apply.stage_launches = 0
