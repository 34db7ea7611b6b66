"""Complex linear systems through their equivalent real form.

Counterpart of ``trilinos_tpu/ops/komplex.py`` (the Komplex package,
Komplex_LinearProblem.h): (Ar + i·Ai)(xr + i·xi) = br + i·bi is solved as
the real 2n × 2n system (the K1 form)

    [ Ar  −Ai ] [xr]   [br]
    [ Ai   Ar ] [xi] = [bi]

whose off-diagonal blocks sit at diagonal offsets ±n. The real form is a
host ``CsrHost``; ``solve_complex`` packs it with ``choose_format`` on the
device and solves it with the solver and preconditioner that ``build``
makes. Vectors convert on the host (numpy).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from .formats import CsrHost


def complex_to_real_csr(ar: CsrHost, ai: CsrHost) -> CsrHost:
    """The 2n × 2n equivalent real form from the real and imaginary
    parts."""
    if ar.shape != ai.shape:
        raise ValueError("Re/Im shape mismatch")
    n = ar.shape[0]
    rr, ri = ar._rows(), ai._rows()
    ac, ic = ar.cols.astype(np.int64), ai.cols.astype(np.int64)
    # blocks: Ar (top left), −Ai (top right), Ai (bottom left), Ar (bottom
    # right)
    rows = np.concatenate([rr, ri, ri + n, rr + n])
    cols = np.concatenate([ac, ic + n, ic, ac + n])
    vals = np.concatenate([ar.vals, -ai.vals, ai.vals, ar.vals])
    return CsrHost.from_coo(rows, cols, vals, (2 * n, 2 * n),
                            sum_duplicates=True)


def complex_matrix_to_real(a_complex) -> CsrHost:
    """The real form of a ``CsrHost`` with complex values (as
    ``io.read_sparse`` gives a complex Matrix Market file) or of a dense
    complex array."""
    if isinstance(a_complex, CsrHost):
        rows = a_complex._rows()
        ar = CsrHost.from_coo(rows, a_complex.cols, np.real(a_complex.vals),
                              a_complex.shape)
        ai = CsrHost.from_coo(rows, a_complex.cols, np.imag(a_complex.vals),
                              a_complex.shape)
        return complex_to_real_csr(ar, ai)
    dense = np.asarray(a_complex)
    return complex_to_real_csr(CsrHost.from_dense(np.real(dense)),
                               CsrHost.from_dense(np.imag(dense)))


def complex_vec_to_real(z, n_pad: int | None = None) -> np.ndarray:
    """[Re z; Im z] on the host, each half padded to ``n_pad`` rows."""
    z = np.asarray(z)
    n = z.shape[0]
    half = n_pad if n_pad is not None else n
    out = np.zeros((2 * half,) + z.shape[1:], dtype=np.real(z).dtype)
    out[:n] = np.real(z)
    out[half:half + n] = np.imag(z)
    return out


def real_vec_to_complex(x, n: int, n_pad: int | None = None) -> np.ndarray:
    """The complex vector of a real-form vector (a tensor or an array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    half = n_pad if n_pad is not None else n
    return x[:n] + 1j * x[half:half + n]


def solve_complex(a, b, params=None, comm=None, device=None):
    """``Komplex_LinearProblem``'s solve: build the real form, solve it
    with the solver and preconditioner of ``solvers.build``'s parameter
    list (default GMRES, no preconditioner), return the complex solution.

    ``a``: a complex dense array, a ``CsrHost`` with complex values, or an
    ``(ar, ai)`` pair of ``CsrHost``. ``b``: a complex vector. The real
    form is stored through ``choose_format`` on ``device`` (``None``: the
    CUDA card) in its values' dtype. Returns ``(z, result)``: the complex
    solution (numpy) and the real form's ``SolveResult``, whose resnorm is
    the complex one (‖r_real‖₂ = ‖r_complex‖₂), so tolerances carry over.
    """
    from ..solvers.factory import build
    from ..solvers.linear_problem import LinearProblem
    from .formats import choose_format
    from .matvec import spmv

    dev = resolve_device(device)
    erf = complex_to_real_csr(*a) if isinstance(a, tuple) \
        else complex_matrix_to_real(a)
    n = erf.shape[0] // 2
    b = np.asarray(b)
    if b.shape[0] != n:
        raise ValueError(f"rhs length {b.shape[0]} != matrix order {n}")
    mgr, prec = build(params or {"Linear Solver Type": "GMRES"}, erf,
                      comm=comm, device=dev)
    op = choose_format(erf, device=dev)
    b_real = np.zeros(op.n_rows_pad, dtype=erf.vals.dtype)
    b_real[:2 * n] = complex_vec_to_real(b)
    problem = LinearProblem(lambda v: spmv(op, v),
                            torch.from_numpy(b_real).to(
                                dev, torch_dtype(erf.vals.dtype)),
                            right_prec=prec)
    res = mgr.solve(problem)
    return real_vec_to_complex(res.x, n), res
