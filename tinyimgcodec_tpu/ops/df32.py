"""Double-float (float32 pair) arithmetic for bit-exact device transforms.

The reference's semantics are defined in float64 (scipy DCT/IDCT + numpy
rounding, reference utils.py:32-53).  To reproduce them *bit-exactly* in
float32 device arithmetic we carry values as an unevaluated sum
``hi + lo`` of two float32s (~49 mantissa bits), using error-free
transformations (Knuth two-sum, Dekker split two-product -- no FMA
dependence; optimization barriers pin the intermediates XLA could
otherwise rewrite).

Accuracy: relative error ~1e-14 per op chain here, far below the ~1e-13
algorithmic error of scipy's own FFT-based float64 DCT, so rounding-tie
decisions agree with the reference in practice; exact rational ties (e.g.
DC coefficients at quality 50) are resolved exactly via residual snapping
in :func:`df_round_half_even` / :func:`df_floor`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Residuals this close to a rounding boundary are treated as exactly on it.
# True coefficient values are either exactly on a boundary (rational cases)
# or, with probability ~snap per coefficient, further away than this.
_SNAP = 1e-9

_SPLIT_FACTOR = np.float32(4097.0)  # 2**12 + 1 (Dekker split for f32)


def _opaque(x):
    """Shield an intermediate from algebraic simplification.

    Error-free transforms rely on exact IEEE rounding of specific
    intermediate expressions; XLA's simplifier may rewrite patterns like
    ``c - (c - a)`` (to ``a``) or contract mul+add into FMA inside
    compiled loop bodies, silently destroying the error terms.  An
    optimization barrier pins the value.
    """
    import jax

    return jax.lax.optimization_barrier(x)


def split_hi_lo(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split float64 constants into (hi, lo) float32 pairs (host side)."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no ordering requirement)."""
    s = _opaque(a + b)
    bb = _opaque(s - a)
    e = (a - _opaque(s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e, requires |a| >= |b|."""
    s = _opaque(a + b)
    e = b - _opaque(s - a)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e via Dekker splitting (FMA-free)."""
    p = _opaque(a * b)
    a1 = _opaque(a * _SPLIT_FACTOR)
    ah = _opaque(a1 - _opaque(a1 - a))
    al = a - ah
    b1 = _opaque(b * _SPLIT_FACTOR)
    bh = _opaque(b1 - _opaque(b1 - b))
    bl = b - bh
    e = (_opaque(ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh+xl) + (yh+yl) as a normalized double-float."""
    sh, se = two_sum(xh, yh)
    se = se + (xl + yl)
    return quick_two_sum(sh, se)


def df_add_float(xh, xl, a):
    sh, se = two_sum(xh, a)
    se = se + xl
    return quick_two_sum(sh, se)


def df_mul_float(xh, xl, a):
    """(xh+xl) * a where a is a plain float32."""
    p, e = two_prod(xh, a)
    e = e + xl * a
    return quick_two_sum(p, e)


def df_mul(xh, xl, yh, yl):
    """(xh+xl) * (yh+yl)."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def df_neg(xh, xl):
    return -xh, -xl


def _residual(h, l, n0):
    """Exact-ish residual (h + l) - n0 for integer-valued n0 near h."""
    d, e = two_sum(h, -n0)
    return d + (e + l)


def df_round_half_even(h, l, snap: float = _SNAP):
    """Round-half-to-even of a double-float, matching np.round on the
    float64 value (reference utils.py:53 forward-quantize semantics).

    Returns (rounded, uncertain): ``uncertain`` marks values within
    ``snap`` of a .5 boundary -- closer than double-float error can
    resolve against the reference's float64 arithmetic (whose own ~1e-16
    rounding error then *defines* the result).  Callers needing
    bit-identity recompute flagged entries on host (engine fixup path);
    unflagged entries are exact.
    """
    n0 = jnp.round(h)  # f32 round-half-even as first approximation
    r = _residual(h, l, n0)
    uncertain = (jnp.abs(jnp.abs(r) - 0.5) < snap)
    # resolve snapped values as exact ties (correct for true rationals)
    r = jnp.where(jnp.abs(r - 0.5) < snap, 0.5, r)
    r = jnp.where(jnp.abs(r + 0.5) < snap, -0.5, r)
    odd = jnp.mod(n0, 2.0) != 0.0
    up = (r > 0.5) | ((r == 0.5) & odd)
    down = (r < -0.5) | ((r == -0.5) & odd)
    return n0 + up.astype(h.dtype) - down.astype(h.dtype), uncertain


def df_floor(h, l, snap: float = _SNAP):
    """Floor of a double-float (decode's truncating uint8 cast for the
    clipped non-negative pixel range, reference codec.py:68-70).

    Returns (floored, uncertain) -- see :func:`df_round_half_even`.
    """
    n0 = jnp.floor(h)
    r = _residual(h, l, n0)  # in (-eps, 1+eps)
    uncertain = (jnp.abs(r) < snap) | (jnp.abs(r - 1.0) < snap)
    r = jnp.where(jnp.abs(r) < snap, 0.0, r)
    r = jnp.where(jnp.abs(r - 1.0) < snap, 1.0, r)
    out = n0 + (r >= 1.0).astype(h.dtype) - (r < 0.0).astype(h.dtype)
    return out, uncertain
