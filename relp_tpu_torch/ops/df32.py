"""Double-float (two-f32) compensated arithmetic: the port of
``relp_tpu.ops.df32``.

Each value is an unevaluated sum ``hi + lo`` of two f32 tensors, about
2^-48 relative accuracy from f32 operations alone, built on error-free
transformations:

* ``two_sum`` (Knuth): exact, ``a + b == s + err`` in real arithmetic;
* ``two_prod`` (Dekker split, no FMA): exact for f32 inputs, since the
  products of 12-bit halves fit a 24-bit mantissa.

Both are exact only if no multiply and add is contracted into an FMA.  Eager
PyTorch runs every elementwise operation as a kernel of its own, so nothing
contracts; for that reason nothing here may use a fused op (``addcmul``,
``lerp``, ``addmm``, a matmul on df halves) or run under ``torch.compile``,
whose generated kernels contract ``a * b + c``.  The functions give the JAX
package's bits on the same f32 inputs (tests/test_torch_df32.py).

Conventions as in the JAX module: a df value is a pair of equal-shape f32
tensors ``(hi, lo)`` with ``|lo| <= ulp(hi)/2``, passed as separate
arguments.
"""

from __future__ import annotations

import numpy as np
import torch

# 2^12 + 1: Dekker's split constant for f32 (24-bit mantissa -> 12-bit
# halves), an f32 0-d tensor so that no Python float enters the products.
_SPLIT = torch.tensor(4097.0, dtype=torch.float32)


def two_sum(a, b):
    """Knuth's exact addition: returns (s, err) with a + b == s + err."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b):
    """Dekker's exact addition, valid when |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's exact product: returns (p, err) with a * b == p + err."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_add(xh, xl, yh, yl):
    """df + df -> df (Dekker add2; relative error ~2^-47)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_neg(xh, xl):
    return -xh, -xl


def df_sub(xh, xl, yh, yl):
    return df_add(xh, xl, -yh, -yl)


def df_mul_f(xh, xl, y):
    """df * f32 -> df."""
    p, e = two_prod(xh, y)
    e = e + xl * y
    return fast_two_sum(p, e)


def df_mul(xh, xl, yh, yl):
    """df * df -> df (drops the lo*lo term: ~2^-47)."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def df_div(xh, xl, yh, yl):
    """df / df -> df via one Newton correction of the f32 quotient."""
    q1 = xh / yh
    # r = x - y*q1, computed in df.
    ph, pl = df_mul_f(yh, yl, q1)
    rh, rl = df_sub(xh, xl, ph, pl)
    q2 = (rh + rl) / yh
    return fast_two_sum(q1, q2)


def df_from_f64(x, device=None):
    """Split a host f64 array into a df pair (hi, lo) of f32 tensors on
    ``device`` (the CPU by default)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return (torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device))


def df_to_f64(hi, lo):
    """Collapse a df pair to host f64."""
    as64 = lambda t: np.asarray(  # noqa: E731
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
        dtype=np.float64,
    )
    return as64(hi) + as64(lo)


def df_reduce_sum(h, l, axis: int):
    """Compensated sum along ``axis`` by pairwise df folding: halves
    ``[:k]`` + ``[k:]`` with ``k = ceil(n/2)``, a zero appended when n is
    odd (the JAX package's fold order, so the bits agree).

    log2(n) vectorized df_add levels; error ~2^-47 log2(n), against the f32
    matmul's ~sqrt(n) 2^-24.
    """
    h = torch.movedim(h, axis, -1)
    l = torch.movedim(l, axis, -1)
    n = h.shape[-1]
    while n > 1:
        k = (n + 1) // 2
        if n % 2:
            h = torch.nn.functional.pad(h, (0, 1))
            l = torch.nn.functional.pad(l, (0, 1))
        h, l = df_add(h[..., :k], l[..., :k], h[..., k:], l[..., k:])
        n = k
    return h[..., 0], l[..., 0]


def df_matvec(Mh, Ml, vh, vl):
    """(df matrix) @ (df vector) -> df vector, fully compensated: exact
    products (two_prod) with first-order cross terms, then the pairwise df
    reduction.  This is the FTRAN ``w = B^-1 a_q`` that f32 accumulation
    gets wrong on ill-conditioned bases."""
    ph, pl = two_prod(Mh, vh[None, :])
    pl = pl + (Mh * vl[None, :] + Ml * vh[None, :])
    return df_reduce_sum(ph, pl, axis=-1)


def df_vecmat(vh, vl, Mh, Ml):
    """(df vector) @ (df matrix) -> df vector (compensated BTRAN-style)."""
    ph, pl = two_prod(Mh, vh[:, None])
    pl = pl + (Mh * vl[:, None] + Ml * vh[:, None])
    return df_reduce_sum(ph, pl, axis=0)


def df_dot(xh, xl, yh, yl):
    """Compensated dot product of two df vectors -> df scalar."""
    ph, pl = two_prod(xh, yh)
    pl = pl + (xh * yl + xl * yh)
    return df_reduce_sum(ph, pl, axis=-1)


def df_axpy(ah, al, xh, xl, yh, yl):
    """y - a*x elementwise on df operands (the rank-1 update primitive)."""
    ph, pl = df_mul(ah, al, xh, xl)
    return df_sub(yh, yl, ph, pl)
