"""Compensated (double-single / float-float) reductions.

Counterpart of ``trilinos_tpu/ops/compensated.py``: error-free transforms
for the dot products and norms that dominate Krylov rounding error.

* ``two_sum``: Knuth's exact addition, a + b = s + e with e exact;
* ``two_prod``: Dekker's exact product by operand splitting, a·b = p + e;
* ``comp_sum``: a float-float pairwise tree reduction, log2(n) sweeps;
* ``comp_dot``: the Ogita-Rump-Oishi Dot2, accurate to about eps instead
  of log2(n)·eps.

The transforms are exact only if no multiply and add is contracted into a
fused multiply-add, so each step is its own eager torch op: no
``torch.compile``, no ``addcmul``, no fused kernel.
"""
from __future__ import annotations

import torch

# Dekker splitter 2^ceil(p/2) + 1, keyed on the exact dtype
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def _split_const(dtype: torch.dtype) -> float:
    try:
        return _SPLIT[dtype]
    except KeyError:
        raise TypeError(f"compensated (double-single) reductions support "
                        f"real f32/f64 only, got {dtype}") from None


def two_sum(a, b):
    """Knuth TwoSum: s = fl(a + b) and its exact error e."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Dekker's FastTwoSum (requires |a| ≥ |b| or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Dekker TwoProd: p = fl(a·b) and its exact error e."""
    p = a * b
    split = _split_const(p.dtype)
    c = split * a
    a_hi = c - (c - a)
    a_lo = a - a_hi
    c = split * b
    b_hi = c - (c - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _renorm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def comp_sum(x: torch.Tensor, dim: int = 0):
    """Float-float tree sum along ``dim``: (hi, lo) with hi + lo the sum to
    about twice the working precision. n need not be a power of two (odd
    tails are carried); the first sweep has no lo array."""
    x = torch.movedim(x, dim, 0)
    n = x.shape[0]
    if n == 1:
        return x[0], torch.zeros_like(x[0])
    half = n // 2
    hi, lo = two_sum(x[:half], x[half:2 * half])
    if n % 2:
        t_hi, t_lo = two_sum(hi[:1], x[-1:])
        hi = torch.cat([t_hi, hi[1:]])
        lo = torch.cat([t_lo + lo[:1], lo[1:]])
    while hi.shape[0] > 1:
        n = hi.shape[0]
        half = n // 2
        s, e = two_sum(hi[:half], hi[half:2 * half])
        lo2 = e + (lo[:half] + lo[half:2 * half])
        s, lo2 = _renorm(s, lo2)
        if n % 2:
            t_hi, t_lo = two_sum(s[:1], hi[-1:])
            s = torch.cat([t_hi, s[1:]])
            lo2 = torch.cat([t_lo + lo[-1:] + lo2[:1], lo2[1:]])
        hi, lo = s, lo2
    return hi[0], lo[0]


def comp_dot(x: torch.Tensor, y: torch.Tensor, dim: int = 0):
    """Dot2: compensated xᵀy along ``dim``, returned as (hi, lo). The product
    errors are summed plainly: their rounding is below the result's own."""
    p, e = two_prod(x, y)
    hi, lo = comp_sum(p, dim)
    s, t = two_sum(hi, e.sum(dim=dim))
    return _renorm(s, t + lo)


def comp_local_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Columnwise compensated dot stacked as [hi, lo]: (2,) for (n,), (2, k)
    for (n, k), shaped for one reduction of both words."""
    return torch.stack(comp_dot(x, y, 0))


def psum_ff(comm, hl: torch.Tensor) -> torch.Tensor:
    """Reduce stacked [hi, lo] partials across ranks and collapse them."""
    s = comm.psum(hl)
    hi, lo = _renorm(s[0], s[1])
    return hi + lo


def comp_dot_global(comm, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Global compensated columnwise dot."""
    return psum_ff(comm, comp_local_dot(x, y))


def comp_norm2(comm, x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(comp_dot_global(comm, x, x))
