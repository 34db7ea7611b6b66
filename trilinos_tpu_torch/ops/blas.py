"""Dense vector kernels (local part): dots, axpby and the block products.

Counterpart of ``trilinos_tpu/ops/blas.py``. Multivectors are
(n_rows_pad, k) tensors whose padding rows stay zero. The JAX package pins
its GEMMs to exact f32 (``precision=HIGHEST``); the port's counterpart is
the float32 matmul setting made when the package is imported (TF32 off).
"""
from __future__ import annotations

import torch


def axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """alpha*x + beta*y."""
    return alpha * x + beta * y


def update(alpha, x, beta, y, gamma, z):
    """alpha*x + beta*y + gamma*z (Tpetra::MultiVector::update, 3-term)."""
    return alpha * x + beta * y + gamma * z


def scale(alpha, x: torch.Tensor) -> torch.Tensor:
    return alpha * x


def local_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Columnwise dot of two (n, k) multivectors → (k,); 0-d for (n,)."""
    if x.ndim == 1:
        return torch.dot(x, y)
    return (x * y).sum(dim=0)


def local_norm2_sq(x: torch.Tensor) -> torch.Tensor:
    return local_dot(x, x)


def _column_blocks(a: torch.Tensor, width: int, dtype: torch.dtype):
    """(start, a[:, start:start+width] in ``dtype``) over a's columns: a
    narrower a (a bf16 Krylov basis) is widened one block at a time, so the
    widened copy is never larger than ``width`` columns."""
    for s in range(0, a.shape[1], max(width, 1)):
        yield s, a[:, s:s + width].to(dtype)


def mv_trans_mv(a: torch.Tensor, b: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """C = alpha·aᵀb for (n, ka), (n, kb) → (ka, kb), in the wider of the
    two dtypes (Belos MvTransMv; the Krylov block inner product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if a.dtype == dt:
        c = a.T @ b.to(dt)
    else:
        c = torch.cat([blk.T @ b for _, blk in
                       _column_blocks(a, b.shape[1], dt)])
    return alpha * c


def mv_times_mat_add_mv(alpha, a: torch.Tensor, b_small: torch.Tensor,
                        beta, c: torch.Tensor | None) -> torch.Tensor:
    """alpha·a·b_small + beta·c (Belos MvTimesMatAddMv): a is (n, ka), b a
    small (ka, kc) matrix; c is not read when beta is 0. The product runs in
    the wider of a's and b's dtypes, as one GEMM whose epilogue adds beta·c;
    alpha = 1 adds no scaling pass."""
    dt = torch.promote_types(a.dtype, b_small.dtype)
    b_small = b_small.to(dt)
    if isinstance(beta, (int, float)) and beta == 0:
        out = None
    else:
        out = c if beta == 1 else beta * c
    for s, blk in (((0, a),) if a.dtype == dt else
                   _column_blocks(a, b_small.shape[1], dt)):
        part = b_small[s:s + blk.shape[1]]
        if out is None:
            out = blk @ part if alpha == 1 else alpha * (blk @ part)
        else:
            out = torch.addmm(out, blk, part, alpha=alpha)
    return out


def set_block(src: torch.Tensor, dst: torch.Tensor,
              cols: tuple[int, ...]) -> torch.Tensor:
    """dst with src's columns written at the given column positions (Belos
    SetBlock), as a new tensor."""
    out = dst.clone()
    out[:, list(cols)] = src.to(dst.dtype)
    return out


def mv_random(n: int, k: int, dtype=torch.float32, n_valid: int | None = None,
              generator: torch.Generator | None = None,
              device=None) -> torch.Tensor:
    """Belos MvRandom: an (n, k) multivector of standard normals drawn from
    ``generator`` on ``device`` (``None``: the CUDA card), rows from
    ``n_valid`` on zero. The reference draws from ``jax.random``, whose
    stream torch cannot match: the law and the zero pad rows are the
    same, the values are not."""
    from ..device import resolve_device, torch_dtype

    dev = resolve_device(device)
    x = torch.randn((n, k), generator=generator, device=dev,
                    dtype=torch_dtype(dtype))
    if n_valid is not None and n_valid < n:
        x[n_valid:] = 0
    return x
