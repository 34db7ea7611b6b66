"""Eigensolver factory: name + parameter list driven eigensolves.

Counterpart of ``trilinos_tpu/eigen/factory.py`` (``Anasazi::Factory``,
AnasaziFactory.hpp, creating a solver manager from a name and a
ParameterList; ``Anasazi::BasicEigenproblem``, AnasaziBasicEigenproblem.hpp,
holding the operator, preconditioner, nev, symmetry flag, mass and initial
vector). Parameter names, defaults and the "Which" maps are the
reference's.

The problem's ``dtype`` is explicit (float64 by default) and ``device``
places the start blocks a kind draws itself (``None``: the CUDA card;
a given ``v0`` tensor keeps its own device).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..parallel.comm import Comm, SerialComm
from ..utils.params import Param, ParameterList, make_params
from .davidson import block_davidson
from .gen_davidson import generalized_davidson
from .krylov_schur import block_krylov_schur
from .lanczos import lanczos_eigs
from .lobpcg import lobpcg, power_method
from .rtr import rtr
from .tracemin import tracemin

ALIASES = {
    "BLOCK KRYLOV SCHUR": "bks",
    "BLOCK_KRYLOV_SCHUR": "bks",
    "BKS": "bks",
    "LOBPCG": "lobpcg",
    "BLOCK DAVIDSON": "davidson",
    "BLOCK_DAVIDSON": "davidson",
    "GENERALIZED DAVIDSON": "gen_davidson",
    "GENERALIZED_DAVIDSON": "gen_davidson",
    "TRACE MIN": "tracemin",
    "TRACEMIN": "tracemin",
    "RTR": "rtr",
    "LANCZOS": "lanczos",
    "POWER": "power",
}

_SPECS = {
    # Anasazi sorts by "Which" ∈ {LM, SM, LR, SR} (AnasaziBasicSort.hpp)
    "Which": Param("Which", "LM", choices=("LM", "SM", "LR", "SR",
                                           "SA", "LA")),
    "Block Size": Param("Block Size", 0),       # 0 → solver default
    "Num Blocks": Param("Num Blocks", 0),       # 0 → solver default
    "Maximum Restarts": Param("Maximum Restarts", 20),
    "Convergence Tolerance": Param("Convergence Tolerance", 1e-8),
    "Maximum Iterations": Param("Maximum Iterations", 200),
    "Inner Iterations": Param("Inner Iterations", 15),  # TraceMin CG steps
    # Block Davidson locking (AnasaziBlockDavidsonSolMgr.hpp:153-157)
    "Use Locking": Param("Use Locking", False),
    "Locking Tolerance": Param("Locking Tolerance", 0.0),  # 0 → 0.1·tol
    "Max Locked": Param("Max Locked", 0),                  # 0 → nev
}

# the symmetric kinds sort by SA/LA, LOBPCG by SM/LM
_SYM_WHICH = {"SR": "SA", "SM": "SA", "SA": "SA",
              "LR": "LA", "LM": "LA", "LA": "LA"}
_LOBPCG_WHICH = {"SR": "SM", "SM": "SM", "SA": "SM",
                 "LR": "LM", "LM": "LM", "LA": "LM"}

# the kinds that honour a mass operator (the generalized pencil)
_MASS_KINDS = ("bks", "lobpcg", "tracemin", "davidson", "gen_davidson",
               "rtr")


def eigensolver_names() -> tuple[str, ...]:
    return tuple(sorted(ALIASES))


@dataclasses.dataclass
class EigenProblem:
    """Anasazi::BasicEigenproblem: operator, nev, symmetry, optional
    preconditioner, mass operator (the pencil A x = λ M x) and initial
    block. ``n`` is the (padded) vector length the operator acts on."""
    op: Callable
    n: int
    nev: int
    symmetric: bool = True      # setHermitian
    prec: Callable | None = None
    v0: np.ndarray | torch.Tensor | None = None  # (n, w) block or (n,)
    dtype: object = torch.float64
    m: Callable | None = None
    device: object = None  # where drawn start blocks go; None: the card


class EigenSolverManager:
    """Parameter-driven wrapper around one eigensolver driver."""

    def __init__(self, name: str, params: ParameterList | dict | None = None,
                 comm: Comm | None = None):
        key = name.strip().upper()
        if key not in ALIASES:
            raise ValueError(
                f"unknown eigensolver {name!r}; valid: {eigensolver_names()}")
        self.name = name
        self.kind = ALIASES[key]
        self.params = make_params(params)
        self.params.validate(_SPECS, strict=False)
        self.comm = comm or SerialComm()

    @staticmethod
    def _device(problem: EigenProblem):
        if isinstance(problem.v0, torch.Tensor):
            return problem.v0.device
        return resolve_device(problem.device)

    def _given_v0(self, problem: EigenProblem):
        if problem.v0 is None:
            return None
        return torch.as_tensor(problem.v0, dtype=torch_dtype(problem.dtype),
                               device=self._device(problem))

    def _v0(self, problem: EigenProblem, width: int):
        """The given start block, else ``default_rng(7)`` normals: (n,)
        for width 0, (n, width) otherwise."""
        if problem.v0 is not None:
            return self._given_v0(problem)
        rng = np.random.default_rng(7)
        v = rng.standard_normal(problem.n if width == 0
                                else (problem.n, width))
        return torch.as_tensor(v, dtype=torch_dtype(problem.dtype),
                               device=self._device(problem))

    def solve(self, problem: EigenProblem):
        p = self.params
        tol = float(p["Convergence Tolerance"])
        maxiter = int(p["Maximum Iterations"])
        which = str(p["Which"])
        nev = problem.nev
        bs = int(p["Block Size"]) or 0
        nb = int(p["Num Blocks"]) or 0
        comm = self.comm
        op, n = problem.op, problem.n
        dtype = torch_dtype(problem.dtype)

        if problem.m is not None and self.kind not in _MASS_KINDS:
            # only these kinds honour the pencil: standard eigenpairs for
            # A x = λ M x would be wrong
            raise ValueError(
                f"{self.name!r} does not support a mass matrix (M); "
                "use 'Block Krylov-Schur', 'LOBPCG', 'TraceMin', "
                "'Block Davidson', 'Generalized Davidson', or 'RTR' "
                "for generalized problems")
        v0 = self._given_v0(problem)
        device = self._device(problem) if v0 is None else v0.device

        if self.kind == "bks":
            kw = dict(which=which, tol=tol,
                      max_restarts=int(p["Maximum Restarts"]),
                      symmetric=problem.symmetric, comm=comm, dtype=dtype,
                      device=device)
            if bs:
                kw["nb"] = bs
            if nb:
                kw["m"] = nb * max(bs, 1)
            if v0 is not None:
                kw["v0"] = v0
            if problem.m is not None:
                kw["mass"] = problem.m
            return block_krylov_schur(op, n, nev, **kw)
        if self.kind == "lobpcg":
            return lobpcg(op, self._v0(problem, bs or nev), prec=problem.prec,
                          m=problem.m, which=_LOBPCG_WHICH[which], tol=tol,
                          maxiter=maxiter, comm=comm)
        if self.kind == "davidson":
            return block_davidson(
                op, n, nev, nb=bs or None,
                smax=(nb * bs) if (nb and bs) else None, prec=problem.prec,
                which=_SYM_WHICH[which], tol=tol, maxiter=maxiter, v0=v0,
                comm=comm, dtype=dtype, m=problem.m,
                locking=bool(p["Use Locking"]),
                lock_tol=float(p["Locking Tolerance"]) or None,
                max_locked=int(p["Max Locked"]) or None, device=device)
        if self.kind == "gen_davidson":
            return generalized_davidson(
                op, n, nev, nb=bs or None,
                smax=(nb * bs) if (nb and bs) else None, prec=problem.prec,
                which=which, tol=tol, maxiter=maxiter, v0=v0, comm=comm,
                dtype=dtype, m=problem.m, device=device)
        if self.kind == "tracemin":
            return tracemin(op, n, nev, block=bs or None, m=problem.m,
                            inner_iters=int(p["Inner Iterations"]), tol=tol,
                            maxiter=maxiter, v0=v0, comm=comm, dtype=dtype,
                            device=device)
        if self.kind == "rtr":
            return rtr(op, n, nev, block=bs or None, tol=tol,
                       maxiter=maxiter, v0=v0, comm=comm, dtype=dtype,
                       m=problem.m, device=device)
        if self.kind == "lanczos":
            return lanczos_eigs(op, self._v0(problem, 0), nev, m=(nb or None),
                                which=which, comm=comm)
        if self.kind == "power":
            return power_method(op, self._v0(problem, 0), maxiter=maxiter,
                                tol=tol, comm=comm)
        raise AssertionError(self.kind)


def create_eigensolver(name: str, params=None,
                       comm: Comm | None = None) -> EigenSolverManager:
    """Anasazi::Factory::create analogue."""
    return EigenSolverManager(name, params, comm)
