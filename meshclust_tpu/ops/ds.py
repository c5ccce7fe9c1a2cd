"""Double-single (two-float32) arithmetic for float64-class decisions.

The device programs compute in float32 (the engine was first written for a
device without float64); the reference makes every clustering decision in
double (Trainer.cpp:115-127, DivergencePoint.cpp:53-81). Plain f32 flips
rare boundary decisions; this module removes them: every classifier score
and distance_d is evaluated as an UNEVALUATED SUM of two float32s
(hi + lo, |lo| <= ulp(hi)/2) using error-free transformations (Dekker 1971,
Knuth TAOCP 2.4). Effective precision ~2^-48 — decisions diverge from
float64 only when a score sits within ~1e-14 (relative) of the boundary,
i.e. on exact rational ties float64 itself cannot split.

Preconditions: the INPUT statistics (man, dot, mag, sq, len) must be
integer-valued and exactly representable in f32 (< 2^24). Backends gate on
`ds_inputs_exact` and fall back to plain f32 otherwise.

All functions take/return (hi, lo) pairs of same-shape f32 arrays and are
jit-traceable. Constants derived from float64 values (normalization bounds,
GLM weights) are split host-side by `from_f64`.

XLA note: error-free transforms require the compiler not to reassociate or
contract these expressions. On an H100, XLA kept `a*b - p` as two rounded
operations (no FMA contraction), but its f32 divide and sqrt are not
correctly rounded (29% and 17% of random operands differ from the IEEE
result): `div` and `sqrt` refine the f32 estimate from an exact residual,
so they stay ~2^-44-accurate, yet a floor of a DS quotient can land one
below an exact integer quotient. Floored means therefore go through
ds_classify.cw_exact. Checked on the card by tests/test_gpu_hw.py.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_SPLIT = np.float32(4097.0)        # 2^12 + 1 (Veltkamp split for f32)


def _opaque(x):
    """Hide a rounded intermediate from XLA's algebraic simplifier.

    Under jit, XLA's simplifier may rewrite (a + b) - a -> b etc., which
    silently deletes the error terms the transforms exist to compute. An
    optimization_barrier keeps the rounding step observable."""
    return jax.lax.optimization_barrier(x)


def from_f64(x) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side split of float64 values into (hi, lo) f32 pairs."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def wrap(x):
    """Lift an exact f32 array to a DS pair."""
    return x, jnp.zeros_like(x)


def _two_sum(a, b):
    s = _opaque(a + b)
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = _opaque(a + b)
    err = b - (s - a)
    return s, err


def _split(a):
    c = _opaque(_SPLIT * a)
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = _opaque(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(x, y):
    """add22 (Dekker): (x.hi+x.lo) + (y.hi+y.lo)."""
    s, e = _two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return _quick_two_sum(s, e)


def sub(x, y):
    return add(x, neg(y))


def neg(x):
    return -x[0], -x[1]


def mul(x, y):
    """mul22: full cross terms at O(eps^2)."""
    p, e = _two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _quick_two_sum(p, e)


def div(x, y):
    """div22: one Newton refinement of the f32 quotient."""
    q1 = x[0] / y[0]
    # r = x - q1 * y, exactly
    p, e = _two_prod(q1, y[0])
    r_hi, r_e = _two_sum(x[0], -p)
    r = r_hi + (r_e + x[1] - e - q1 * y[1])
    q2 = r / y[0]
    return _quick_two_sum(q1, q2)


def sqrt(x):
    """sqrt22: one Newton step on the f32 root. x >= 0 (0 stays 0)."""
    s = jnp.sqrt(x[0])
    safe = jnp.where(s > 0, s, jnp.float32(1.0))
    p, e = _two_prod(safe, safe)
    d_hi, d_e = _two_sum(x[0], -p)
    corr = (d_hi + (d_e + x[1] - e)) / (2.0 * safe)
    hi, lo = _quick_two_sum(safe, corr)
    zero = x[0] <= 0
    return jnp.where(zero, 0.0, hi), jnp.where(zero, 0.0, lo)


def scale(x, c: float):
    """Multiply by an f32-exact constant. Power-of-two scales are exact
    per component; anything else routes through mul (the product of hi
    with e.g. 10000 rounds, and that error must be captured)."""
    import math
    m, _ = math.frexp(float(c))
    cf = jnp.float32(c)
    if abs(m) == 0.5:
        return x[0] * cf, x[1] * cf
    return mul(x, (cf, jnp.zeros_like(x[0])))


def ge_zero(x):
    """sign(hi+lo) >= 0. Normalized pairs: sign(hi) decides unless hi==0."""
    return (x[0] > 0) | ((x[0] == 0) & (x[1] >= 0))


def gt(x, y):
    """Lexicographic (hi, lo) strict greater-than."""
    return (x[0] > y[0]) | ((x[0] == y[0]) & (x[1] > y[1]))


def lt(x, y):
    return gt(y, x)


def where(c, x, y):
    return jnp.where(c, x[0], y[0]), jnp.where(c, x[1], y[1])


def maximum(x, y):
    return where(gt(x, y), x, y)


def to_f64(x) -> np.ndarray:
    """Host-side: collapse a (hi, lo) pair of numpy arrays to float64."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def ds_inputs_exact(max_mag: int, max_sq: int) -> bool:
    """True when every integer statistic the classifier consumes fits
    exactly in f32: man <= 2*max_mag, dot <= max_sq (Cauchy-Schwarz with
    equal bounds), mag/sq themselves.

    MESHCLUST_FORCE_F32=1 disables the DS path globally (perf experiments
    only — f32 decisions may flip on ~1e-7-relative boundary ties)."""
    import os
    if os.environ.get("MESHCLUST_FORCE_F32") == "1":
        return False
    return (2 * int(max_mag) < (1 << 24)) and (int(max_sq) < (1 << 24))
