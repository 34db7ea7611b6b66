"""Solver factory, SolverManager and the Stratimikos-style ``build``.

Counterpart of ``trilinos_tpu/solvers/factory.py`` (Belos::SolverFactory
with the alias table of Belos' EBelosSolverType, and the SolverManager
parameter surface: "Convergence Tolerance" 1e-8, "Maximum Iterations",
"Num Blocks", "Maximum Restarts", "Orthogonalization", ...). ``ALIASES``
maps the 30 accepted names onto 21 solver kinds and ``_SPECS`` holds the
parameters, both key for key the reference's. The manager prints the
final summary (FINAL_SUMMARY verbosity) after the solve.
"""
from __future__ import annotations

import torch

from ..parallel.comm import Comm, SerialComm
from ..utils.output import MsgType, OutputManager
from ..utils.params import Param, ParameterList, make_params
from .base import SolveResult
from .bicgstab import bicgstab
from .block_gmres import block_gmres
from .cg import cg, cg_pipeline, cg_single_reduce, stochastic_cg
from .gmres import fgmres, gmres
from .linear_problem import LinearProblem
from .lsqr import fixed_point, lsqr
from .minres import minres
from .tfqmr import tfqmr

# accepted name (upper case) -> solver kind, the reference's alias table
ALIASES = {
    "CG": "cg",
    "PSEUDOBLOCK CG": "cg",
    "PSEUDO BLOCK CG": "cg",
    "BLOCK CG": "block_cg",
    "SINGLE REDUCE CG": "cg_single_reduce",
    "PSEUDOBLOCK STOCHASTIC CG": "stochastic_cg",
    "STOCHASTIC CG": "stochastic_cg",
    "PIPELINED CG": "cg_pipeline",
    "GMRES": "gmres",
    "PSEUDOBLOCK GMRES": "gmres",
    "PSEUDO BLOCK GMRES": "gmres",
    "BLOCK GMRES": "block_gmres",
    "FLEXIBLE GMRES": "fgmres",
    "BICGSTAB": "bicgstab",
    "MINRES": "minres",
    "TFQMR": "tfqmr",
    "PSEUDOBLOCK TFQMR": "tfqmr",
    "LSQR": "lsqr",
    "FIXED POINT": "fixed_point",
    "GCRODR": "gcrodr",
    "S-STEP GMRES": "sstep",
    "SINGLE REDUCE GMRES": "gmres_sr",
    "PIPELINED GMRES": "gmres_pipe",
    "RCG": "rcg",
    "PCPG": "pcpg",
    "CA-GMRES": "sstep",
    "BLOCK GCRODR": "block_gcrodr",
    # GmresPolySolMgr: the GMRES polynomial built from the problem is the
    # (composed) right preconditioner of the outer GMRES
    "HYBRID BLOCK GMRES": "hybrid_gmres",
    "GMRESPOLY": "hybrid_gmres",
    "SEED GMRES": "hybrid_gmres",
}

_SPECS = {
    "Convergence Tolerance": Param("Convergence Tolerance", 1e-8),
    "Maximum Iterations": Param("Maximum Iterations", 1000),
    "Num Blocks": Param("Num Blocks", 30),
    "Maximum Restarts": Param("Maximum Restarts", 20),
    "Block Size": Param("Block Size", 1),
    "Orthogonalization": Param("Orthogonalization", "ICGS",
                               choices=("DGKS", "ICGS", "IMGS", "CGS2",
                                        "MGS1")),
    "Verbosity": Param("Verbosity", int(MsgType.ERRORS)),
    "Damping": Param("Damping", 0.0),
    "Num Recycled Blocks": Param("Num Recycled Blocks", 8),
    "Step Size": Param("Step Size", 4),
    # s-step basis: Newton takes Leja-ordered Ritz shifts from an s-step
    # Arnoldi on b before the solve
    "Step Basis": Param("Step Basis", "Monomial",
                        choices=("Monomial", "Newton")),
    "Fixed Point Omega": Param("Fixed Point Omega", 1.0),
    # GmresPolySolMgr: degree of the GMRES polynomial
    "Maximum Degree": Param("Maximum Degree", 25),
    # CG records this many coefficient pairs for its Lanczos condition
    # estimate; GMRES takes any nonzero value as "estimate"
    "Estimate Condition Number": Param("Estimate Condition Number", 0),
    # the per-iteration residual trace (CG and GMRES kinds)
    "Record Residual History": Param("Record Residual History", False),
    # the Krylov basis stored in bf16 (GMRES kinds only)
    "Basis Precision": Param("Basis Precision", "default",
                             choices=("default", "bf16")),
}

# kinds whose iteration stores a narrow basis
_BF16_KINDS = ("gmres", "fgmres", "block_gmres", "sstep", "hybrid_gmres")


def solver_names() -> tuple[str, ...]:
    return tuple(sorted(ALIASES))


class SolverManager:
    """Parameter-driven wrapper around one Krylov solver. Recycling kinds
    keep their space on the manager (``recycle_space``,
    ``cg_recycle_space``) for the next solve; stochastic CG keeps its
    sample as ``stochastic_vector``."""

    def __init__(self, name: str, params: ParameterList | dict | None = None,
                 comm: Comm | None = None):
        key = name.strip().upper()
        if key not in ALIASES:
            raise ValueError(
                f"unknown solver {name!r}; valid: {solver_names()}")
        self.name = name
        self.kind = ALIASES[key]
        self.params = make_params(params)
        self.params.validate(_SPECS, strict=False)
        self.comm = comm or SerialComm()
        self.output = OutputManager(self.params["Verbosity"])

    def solve(self, problem: LinearProblem) -> SolveResult:
        problem.set_problem()
        p = self.params
        maxiter = int(p["Maximum Iterations"])
        common = dict(rtol=float(p["Convergence Tolerance"]), comm=self.comm)
        op, b, x0 = problem.op, problem.b, problem.x0
        ortho = str(p["Orthogonalization"])
        hist = bool(p["Record Residual History"])
        stop = getattr(problem, "stop_test", None)
        left = problem.left_prec or problem.right_prec
        right = problem.right_prec or problem.left_prec
        basis_dtype = (torch.bfloat16
                       if str(p["Basis Precision"]) == "bf16" else None)
        if basis_dtype is not None and self.kind not in _BF16_KINDS:
            # a kind without narrow-basis storage refuses instead of
            # solving silently with the full-precision basis
            raise ValueError(
                f"{self.name!r} does not implement 'Basis Precision': "
                "'bf16'; supported kinds: GMRES, Flexible GMRES, Block "
                "GMRES, S-STEP/CA-GMRES, Hybrid Block GMRES")
        kind = self.kind
        if kind == "cg":
            res = cg(op, b, x0, prec=left, maxiter=maxiter,
                     condest_window=int(p["Estimate Condition Number"]),
                     history=hist, stop=stop, **common)
        elif kind == "block_cg":
            from .block_cg import block_cg

            res = block_cg(op, b, x0, prec=left, maxiter=maxiter, **common)
        elif kind == "hybrid_gmres":
            res = self._hybrid_gmres(op, b, x0, right, maxiter, ortho,
                                     basis_dtype, common)
        elif kind == "cg_single_reduce":
            res = cg_single_reduce(op, b, x0, prec=left, maxiter=maxiter,
                                   **common)
        elif kind == "cg_pipeline":
            res = cg_pipeline(op, b, x0, prec=left, maxiter=maxiter,
                              **common)
        elif kind == "stochastic_cg":
            res, self.stochastic_vector = stochastic_cg(
                op, b, x0, prec=left, maxiter=maxiter, **common)
        elif kind in ("gmres_sr", "gmres_pipe"):
            from .gmres_ca import gmres_pipeline, gmres_single_reduce

            fn = gmres_single_reduce if kind == "gmres_sr" else gmres_pipeline
            res = fn(op, b, x0, prec=right, restart=int(p["Num Blocks"]),
                     maxiter=maxiter, **common)
        elif kind in ("gmres", "fgmres"):
            fn = fgmres if kind == "fgmres" else gmres
            res = fn(op, b, x0, prec=right, restart=int(p["Num Blocks"]),
                     maxiter=maxiter, ortho=ortho,
                     condest=bool(int(p["Estimate Condition Number"])),
                     history=hist, stop=stop, basis_dtype=basis_dtype,
                     **common)
        elif kind == "block_gmres":
            bb = b[:, None] if b.ndim == 1 else b
            xx = x0[:, None] if (x0 is not None and x0.ndim == 1) else x0
            res = block_gmres(op, bb, xx, prec=right,
                              num_blocks=int(p["Num Blocks"]),
                              max_restarts=int(p["Maximum Restarts"]),
                              ortho=ortho, basis_dtype=basis_dtype, **common)
            if b.ndim == 1:
                res = SolveResult(x=res.x[:, 0], iters=res.iters,
                                  resnorm=res.resnorm[0],
                                  converged=res.converged[0])
        elif kind == "bicgstab":
            res = bicgstab(op, b, x0, prec=right, maxiter=maxiter, **common)
        elif kind == "minres":
            res = minres(op, b, x0, prec=left, maxiter=maxiter, **common)
        elif kind == "tfqmr":
            res = tfqmr(op, b, x0, prec=right, maxiter=maxiter, **common)
        elif kind == "lsqr":
            op_t = getattr(problem, "op_t", None)
            if op_t is None:
                raise ValueError("LSQR needs problem.op_t (transpose apply)")
            res = lsqr(op, op_t, b, x0, maxiter=maxiter,
                       damp=float(p["Damping"]), **common)
        elif kind == "pcpg":
            from .rcg import pcpg

            basis = getattr(problem, "constraint_basis", None)
            if basis is None:
                raise ValueError(
                    "PCPG needs problem.constraint_basis (n, k) array")
            res = pcpg(op, b, basis, x0, maxiter=maxiter, prec=left,
                       **common)
        elif kind == "rcg":
            from .rcg import rcg

            res, self.cg_recycle_space = rcg(
                op, b, x0, recycle_dim=int(p["Num Recycled Blocks"]),
                maxiter=maxiter, prec=left,
                recycle=getattr(self, "cg_recycle_space", None), **common)
        elif kind == "sstep":
            res = self._sstep(op, b, x0, right, basis_dtype, common)
        elif kind in ("gcrodr", "block_gcrodr"):
            from .block_gcrodr import block_gcrodr
            from .gcrodr import gcrodr

            # one right-hand side: the block algorithm at nb = 1 is GCRO-DR
            fn = block_gcrodr if kind == "block_gcrodr" and b.ndim == 2 \
                else gcrodr
            res, self.recycle_space = fn(
                op, b, x0, num_blocks=int(p["Num Blocks"]),
                recycle_dim=int(p["Num Recycled Blocks"]),
                max_cycles=int(p["Maximum Restarts"]) + 1, prec=right,
                recycle=getattr(self, "recycle_space", None), **common)
        elif kind == "fixed_point":
            res = fixed_point(op, b, x0, prec=left, maxiter=maxiter,
                              omega=float(p["Fixed Point Omega"]), **common)
        else:  # pragma: no cover
            raise AssertionError(kind)
        self.output.print(
            MsgType.FINAL_SUMMARY,
            f"[{self.name}] iters={int(res.iters)} "
            f"resnorm={float(torch.as_tensor(res.resnorm).max()):.3e} "
            f"converged={bool(torch.as_tensor(res.converged).all())}")
        return res

    def _hybrid_gmres(self, op, b, x0, m_user, maxiter, ortho, basis_dtype,
                      common):
        """GmresPolySolMgr: p(A∘M) from the first right-hand side, composed
        with the user's M as the right preconditioner of GMRES."""
        from ..precond.poly import gmres_poly_apply, gmres_poly_setup

        op_eff = op if m_user is None else (lambda v: op(m_user(v)))
        seed = b if b.ndim == 1 else b[:, 0]
        if float(torch.linalg.vector_norm(seed)) == 0.0:
            # a zero seed builds no polynomial (0/0): plain GMRES, which
            # returns x = 0 converged like every other kind
            comp = m_user
        else:
            h, y, deg = gmres_poly_setup(op_eff, seed,
                                         int(self.params["Maximum Degree"]))

            def poly(v):
                return gmres_poly_apply(op_eff, h, y, deg, v)

            comp = poly if m_user is None else (lambda v: m_user(poly(v)))
        return gmres(op, b, x0, prec=comp,
                     restart=int(self.params["Num Blocks"]), maxiter=maxiter,
                     ortho=ortho, basis_dtype=basis_dtype, **common)

    def _sstep(self, op, b, x0, prec, basis_dtype, common):
        """S-step (CA-) GMRES; "Step Basis" Newton takes Ritz shifts of the
        operator the basis recurrence applies (op∘M when preconditioned)."""
        from .sstep_gmres import ritz_shifts, sstep_gmres

        p = self.params
        s = int(p["Step Size"])
        shifts = None
        if str(p["Step Basis"]).lower() == "newton":
            op_m = op if prec is None else (lambda v: op(prec(v)))
            shifts = ritz_shifts(op_m, b, s, comm=self.comm)
        return sstep_gmres(op, b, x0, s=s,
                           t_blocks=max(int(p["Num Blocks"]) // s, 1),
                           max_restarts=int(p["Maximum Restarts"]),
                           shifts=shifts, prec=prec, basis_dtype=basis_dtype,
                           **common)


def create_solver(name: str, params=None, comm: Comm | None = None
                  ) -> SolverManager:
    return SolverManager(name, params, comm)


def build(params: ParameterList | dict, a_csr=None, comm: Comm | None = None,
          device=None, **prec_kw):
    """Stratimikos-style set-up (Stratimikos' default linear solver factory):
    one parameter list picks the solver and the preconditioner.

        {"Linear Solver Type": "GMRES",
         "Solver Types": {"GMRES": {...solver parameters...}},
         "Preconditioner Type": "CHEBYSHEV",
         "Preconditioner Types": {"CHEBYSHEV": {...}}}

    Returns (solver_manager, computed preconditioner or None). ``a_csr``
    (a ``CsrHost``) is needed when a preconditioner is asked for;
    ``device`` goes to the preconditioner (None: the card), and so do
    ``prec_kw``, the constructor's other keywords (HIPTMAIR's discrete
    gradient ``aux_op``; the reference's ``build`` has no way to pass it)."""
    p = make_params(params)
    sname = p.get("Linear Solver Type", "CG")
    mgr = SolverManager(sname, p.sublist("Solver Types").sublist(sname), comm)
    pname = p.get("Preconditioner Type", "None")
    prec = None
    if pname and pname != "None":
        from .. import precond

        if a_csr is None:
            raise ValueError("preconditioner requested but no matrix given")
        pparams = p.sublist("Preconditioner Types").sublist(pname)
        prec = precond.create(pname, a_csr, pparams, device=device,
                              **prec_kw).compute()
    return mgr, prec
