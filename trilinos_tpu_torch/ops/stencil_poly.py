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
(``_poly_kernel``, ``_stage_strip``). One launch computes every stage:
x is read once and only the outputs are written (u_s, or u_1..u_s), so
its bound is (1 + n_out)·n·itemsize over 3.35 TB/s. It blocks in time
along z: a block owns an xy tile and a z-chunk and marches along z; x
enters a shared-memory ring of plane tiles with the halo of every stage,
each stage j works on the tile grown by the reach of the stages after it
(overlapped tiling), runs rz·(earlier α ≠ 0 stages) planes behind x (the
TPU kernel's wavefront lag) and keeps its planes in a ring of its own.
:func:`stencil_poly_plan` chooses the tile, the z-chunk, the reach, the
rings and the shared memory on the host, and splits the chain into
consecutive launches where all s stages do not fit one block's shared
memory; the launcher checks the plan. On the card the time goes to the
stage points' shared-memory instructions, not to bytes; the kernel has a
fast instance for Galeri's 7-point cross. Each stage is bitwise the plain
version's (same term order, zero coefficients skipped, no fused
multiply-add). ``stencil_poly_apply.launches`` and
``stencil_powers_apply.launches`` count applies; their
``.kernel_launches`` count the fused launches those applies made (one per
apply unless the plan splits the chain).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .cg_fused import stencil_radii
from .dispatch import use_kernel
from .matvec import spmv
from .stencil_op import (MAX_GRID_YZ, MAX_TERMS, StencilOp, _terms,
                         stencil_spmv_plain)

MAX_STAGES = 8  # csrc/stencil_poly.cu TT_MAX_STAGES
THREADS = 256  # csrc/stencil_poly.cu TT_POLY_THREADS: threads a block
DEPTH = 2  # csrc/stencil_poly.cu TT_POLY_DEPTH: x planes in flight
# the xy extent of a block's input region, by item size: a larger region
# does less redundant halo work but needs more shared memory. A warp walks
# a region row 32 columns at a time and the block's 8 warps take 8 rows,
# so the tile is this extent less the chain's halo (see poly_tile).
REGION = {4: (64, 32), 8: (64, 16)}
TARGET_BLOCKS = 512  # z-chunks are cut so a launch has about this many
MIN_ZC = 8  # shorter chunks would load mostly halo planes
MAX_SMEM = 232448  # bytes of shared memory one block may take

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIG = [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
        _P, _P, _P]
_TYPES = {torch.float32: "f32", torch.float64: "f64"}


@dataclasses.dataclass(frozen=True)
class PolyLaunch:
    """One fused launch: stages ``first + 1 .. first + count``. Ring m
    (m = 0: the launch's input u_first; m ≥ 1: the output of its m-th
    stage) holds ``slots[m]`` plane tiles of the block's tile grown by
    ``reach[m]`` times the radii; the last stage (reach 0) keeps no ring.
    ``smem`` is the rings' bytes and one zero plane of ring 0's extent."""

    first: int
    count: int
    reach: tuple[int, ...]  # m = 0 .. count
    slots: tuple[int, ...]  # m = 0 .. count − 1
    smem: int


@dataclasses.dataclass(frozen=True)
class PolyPlan:
    """Geometry of the fused stencil polynomial: block (bx, by, bz) of
    ``THREADS`` threads owns the ``tile`` at (bx·tile[0], by·tile[1]) and
    the output planes [bz·zc, (bz+1)·zc); ``launches`` cover the stages
    in order."""

    tile: tuple[int, int]
    zc: int
    radii: tuple[int, int, int]
    grid: tuple[int, int, int]
    launches: tuple[PolyLaunch, ...]

    def fields(self, launch: PolyLaunch) -> np.ndarray:
        """The int32 array the C launcher reads for ``launch``."""
        slots = list(launch.slots) + [0] * (MAX_STAGES - len(launch.slots))
        return np.asarray([*self.tile, self.zc, *self.radii, THREADS,
                           launch.smem, *self.grid, launch.first,
                           launch.count, *slots], dtype=np.int32)

    @property
    def redundancy(self) -> float:
        """Stage points computed per output point, over the stages, from
        the xy halos alone (the z-chunks' halo planes not counted)."""
        tx, ty = self.tile
        rx, ry, _ = self.radii
        work = sum((tx + 2 * h * rx) * (ty + 2 * h * ry)
                   for ln in self.launches for h in ln.reach[1:])
        return work / (tx * ty * sum(ln.count for ln in self.launches))


def _launch_geometry(stages, first, radii, tile, itemsize) -> PolyLaunch:
    """Reach, ring slots and shared bytes of one launch of ``stages``
    (the chain's stages first + 1 ..). Stage m runs rz·(α ≠ 0 stages
    among 1..m) planes behind the input; ring m keeps every plane a later
    stage of the launch still reads: stage m + 1's neighbours (2·rz planes
    when its α ≠ 0), stage m + 2's γ term and, for the chain's x (first =
    0), each stage's ζ term; the input ring holds DEPTH planes more in
    flight. Every plane keeps rows of the input region's width. After the
    rings, one zero plane of the input's extent, which the neighbour terms
    on planes outside z_bounds read."""
    rx, ry, rz = radii
    tx, ty = tile
    ns = len(stages)
    a = [0] + [int(st[0] != 0.0) for st in stages]  # a[m]: stage m has α
    reach = tuple(sum(a[m + 1:]) for m in range(ns + 1))
    lag = [rz * (reach[0] - reach[m]) for m in range(ns + 1)]
    slots = []
    for m in range(ns):
        d = 2 * rz * a[m + 1]
        if m + 2 <= ns and stages[m + 1][2] != 0.0:
            d = max(d, rz * (a[m + 1] + a[m + 2]))
        if m == 0 and first == 0:
            d = max([d] + [lag[j] for j in range(1, ns + 1)
                           if stages[j - 1][3] != 0.0])
        slots.append(d + 1 + (DEPTH if m == 0 else 0))
    # every plane has rows of region 0's width; the rings, then one zero
    # plane of region 0's extent for masked terms
    rows = [ty + 2 * h * ry for h in reach]
    smem = itemsize * (tx + 2 * reach[0] * rx) * (
        sum(sl * rows[m] for m, sl in enumerate(slots)) + rows[0])
    return PolyLaunch(first=first, count=ns, reach=reach, slots=tuple(slots),
                      smem=smem)


def poly_tile(itemsize: int, reach: int, radii) -> tuple[int, int]:
    """The xy output tile for a chain with ``reach`` α ≠ 0 stages: the
    item size's REGION less the halo 2·reach·(rx, ry), widened by 32
    columns (8 rows) until it holds at least 16 columns (8 rows), so the
    input region is whole warps wide."""
    (wx, wy), (rx, ry, _) = REGION[itemsize], radii
    tx, ty = wx - 2 * reach * rx, wy - 2 * reach * ry
    while tx < 16:
        tx += 32
    while ty < 8:
        ty += 8
    return tx, ty


@functools.lru_cache(maxsize=64)
def stencil_poly_plan(op: StencilOp, stages, itemsize: int) -> PolyPlan:
    """The fused kernel's geometry for the chain ``stages`` (float 4-tuples)
    on elements of ``itemsize`` bytes: the tile of :func:`poly_tile` for
    the whole chain's reach, z-chunks of at least MIN_ZC planes for about
    TARGET_BLOCKS blocks, and the stages cut greedily into launches whose
    rings fit MAX_SMEM. Raises ValueError where not even one stage fits or
    the grid breaks a launch limit."""
    nx, ny, nz = op.dims
    radii = stencil_radii(op)
    tile = poly_tile(itemsize, sum(st[0] != 0.0 for st in stages), radii)
    launches, first = [], 0
    while first < len(stages):
        count = 0
        while first + count < len(stages):
            ln = _launch_geometry(stages[first:first + count + 1], first,
                                  radii, tile, itemsize)
            if ln.smem > MAX_SMEM:
                break
            best, count = ln, count + 1
        if count == 0:
            raise ValueError(f"stencil polynomial: one stage needs {ln.smem} "
                             f"bytes of shared memory > {MAX_SMEM}")
        launches.append(best)
        first += count
    tiles_x, tiles_y = -(-nx // tile[0]), -(-ny // tile[1])
    zc = min(nz, max(MIN_ZC, -(-tiles_x * tiles_y * nz // TARGET_BLOCKS)))
    grid = (tiles_x, tiles_y, -(-nz // zc))
    if max(grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"stencil polynomial: grid {grid} passes gridDim.y, "
                         f"gridDim.z ≤ {MAX_GRID_YZ}")
    return PolyPlan(tile=tile, zc=zc, radii=radii, grid=grid,
                    launches=tuple(launches))


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


def stored_stages(plan: PolyPlan, stages, all_outputs: bool):
    """The stages whose outputs go to device memory: every stage (all
    outputs) or u_s, and what a later launch reads: its input u_first and,
    where its first stage has γ ≠ 0, u_{first−1} (x itself for 0)."""
    keep = set(range(1, len(stages) + 1)) if all_outputs else {len(stages)}
    for ln in plan.launches[1:]:
        keep.add(ln.first)
        if stages[ln.first][2] != 0.0 and ln.first >= 2:
            keep.add(ln.first - 1)
    return tuple(sorted(keep))


def _check_kernel_input(op: StencilOp, x: torch.Tensor) -> None:
    if x.dtype not in _TYPES:
        raise TypeError(f"stencil polynomial kernel takes float32/float64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("stencil polynomial kernel takes a contiguous x")
    if len(op.offsets) > MAX_TERMS:
        raise ValueError(f"stencil polynomial kernel takes ≤ {MAX_TERMS} "
                         f"terms")


def _launch(op: StencilOp, stages, x: torch.Tensor, z_bounds,
            all_outputs: bool, plan: PolyPlan) -> torch.Tensor:
    """The launches of ``plan`` on the current stream, each one call of
    ``stencil_poly_<type>``; outputs a later launch reads and the poly
    mode does not return go to scratch rows."""
    lib = _build.load("stencil_poly", {f"stencil_poly_{t}": _SIG
                                       for t in _TYPES.values()})
    dx, dy, dz, lin, c = _terms(op)
    s, npad = len(stages), op.n_rows_pad
    out = torch.empty((s, npad) if all_outputs else (npad,), dtype=x.dtype,
                      device=x.device)
    keep = stored_stages(plan, stages, all_outputs)
    rows = [j for j in keep if not all_outputs and j != s]
    scratch = torch.empty((len(rows), npad), dtype=x.dtype, device=x.device)
    where = {0: x}
    for j in keep:
        where[j] = (out[j - 1] if all_outputs else out if j == s
                    else scratch[rows.index(j)])
    coeffs = np.asarray(stages, dtype=np.float64)
    fn = getattr(lib, f"stencil_poly_{_TYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for ln in plan.launches:
            j1 = ln.first + ln.count
            outs = np.asarray([where[j].data_ptr() if j in where else 0
                               for j in range(ln.first + 1, j1 + 1)],
                              dtype=np.uint64)
            prev2 = where[ln.first - 1] if ln.first >= 1 else None
            fields = plan.fields(ln)
            sc = np.ascontiguousarray(coeffs[ln.first:j1])
            rc = fn(where[ln.first].data_ptr(),
                    None if prev2 is None else prev2.data_ptr(),
                    x.data_ptr(), outs.ctypes.data, op.n_rows, npad,
                    *op.dims, z_bounds[0], z_bounds[1], len(op.offsets),
                    dx.ctypes.data, dy.ctypes.data, dz.ctypes.data,
                    lin.ctypes.data, c.ctypes.data, sc.ctypes.data,
                    fields.ctypes.data, stream)
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
    _check_kernel_input(op, x)
    plan = stencil_poly_plan(op, stages, x.element_size())
    y = _launch(op, stages, x, zb, False, plan)
    stencil_poly_apply.launches += 1
    stencil_poly_apply.kernel_launches += len(plan.launches)
    return y


def stencil_powers_apply(op: StencilOp, stages, x: torch.Tensor,
                         z_bounds=None) -> torch.Tensor:
    """The (s, n_pad) stack [u_1; …; u_s] (the matrix-powers basis): the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    stages, zb = _validate(op, stages, x, z_bounds)
    if not use_kernel(x):
        return stencil_powers_plain(op, stages, x, zb)
    _check_kernel_input(op, x)
    plan = stencil_poly_plan(op, stages, x.element_size())
    y = _launch(op, stages, x, zb, True, plan)
    stencil_powers_apply.launches += 1
    stencil_powers_apply.kernel_launches += len(plan.launches)
    return y


stencil_poly_apply.launches = stencil_poly_apply.kernel_launches = 0
stencil_powers_apply.launches = stencil_powers_apply.kernel_launches = 0
