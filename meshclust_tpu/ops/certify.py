"""Certified-f32 classifier decisions: f32 speed, float64 answers.

The DS (double-single, ops/ds.py) path makes every clustering decision
bit-identical to the reference's float64 code (Trainer.cpp:115-127,
DivergencePoint.cpp:53-81), but its error-free transforms cost ~10-20x the
f32 op count and fragment XLA fusion. This module gets the same decisions at
plain-f32 cost:

  1. evaluate the classifier score / f1 / distance_d in ordinary f32
     (fully fused by XLA), and ALONGSIDE it a propagated forward error
     bound `eps` such that |f64_value - f32_value| <= eps;
  2. a decision is CERTAIN when its margin exceeds the bound
     (|score| > eps; argmin/argmax gap > eps); the f32 answer then equals
     the f64 answer by construction;
  3. the rare uncertain case falls back to the exact DS evaluation under
     `lax.cond` — paid only when a score sits within ~1e-5 of a boundary.

Error propagation is standard running error analysis (Higham, Accuracy and
Stability of Numerical Algorithms, ch. 3): each (value, err) pair satisfies
|real - value| <= err, with per-op unit roundoff u = 2^-23 (one bit above
the true 2^-24 to absorb FMA contraction / reassociation differences under
XLA's excess-precision compilation) and a global safety factor folded into
`U`. Inputs (man, dot, mag, sq, len) must be exact integers in f32 — the
same `ds.ds_inputs_exact` precondition the DS path has.

Tie semantics: equal-input rows produce bitwise-equal f32 values, so
first-occurrence tie-breaks agree with f64 without any fallback; argmin /
argmax certification therefore only flags rows whose INPUT statistics
differ from the winner's (see `near_distinct`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meshclust_tpu.ops import features as F

# unit roundoff with 1 safety bit; the public bounds carry SAFETY more.
_U = np.float32(2.0 ** -23)
SAFETY = np.float32(8.0)


class EV:
    """(value, errbound) pair: |real - val| <= err, both f32 arrays."""
    __slots__ = ("v", "e")

    def __init__(self, v, e):
        self.v = v
        self.e = e


def exact(v):
    return EV(v, jnp.zeros_like(v))


def const(v):
    """A f32 constant standing for an f64 value: rep error <= u*|v|."""
    return EV(v, jnp.abs(v) * _U)


def add(x: EV, y: EV) -> EV:
    v = x.v + y.v
    return EV(v, x.e + y.e + jnp.abs(v) * _U)


def sub(x: EV, y: EV) -> EV:
    v = x.v - y.v
    return EV(v, x.e + y.e + jnp.abs(v) * _U)


def mul(x: EV, y: EV) -> EV:
    v = x.v * y.v
    e = jnp.abs(x.v) * y.e + jnp.abs(y.v) * x.e + x.e * y.e \
        + jnp.abs(v) * _U
    return EV(v, e)


def div(x: EV, y: EV) -> EV:
    v = x.v / y.v
    den = jnp.maximum(jnp.abs(y.v) - y.e, np.float32(1e-30))
    e = (x.e + jnp.abs(v) * y.e) / den + jnp.abs(v) * _U
    return EV(v, e)


def sqrt(x: EV) -> EV:
    v = jnp.sqrt(jnp.maximum(x.v, 0.0))
    lo = jnp.maximum(x.v - x.e, 0.0)
    # |sqrt(real)-sqrt(val)| <= err / (sqrt(real)+sqrt(val)) <= err/sqrt(lo)
    e = jnp.where(lo > 0, x.e / (jnp.sqrt(lo) + v + np.float32(1e-30)),
                  v + jnp.sqrt(x.e))
    return EV(v, e + v * _U)


def scale_exact(x: EV, c: float) -> EV:
    """Multiply by an exactly-representable constant (0.5, 2, V, ...)."""
    cf = jnp.float32(c)
    return EV(x.v * cf, x.e * jnp.abs(cf) + jnp.abs(x.v * cf) * _U)


def maximum0(x: EV) -> EV:
    return EV(jnp.maximum(x.v, 0.0), x.e)


def _single(flag: int, man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b,
            V: int) -> EV:
    """One raw feature statistic with error bound. Mirrors
    ds_classify._single / features.raw_from_sums (Feature.cpp:206-339
    semantics). All inputs are exact-integer f32 EVs."""
    w = exact
    if flag == F.FEAT_LD:
        return w(jnp.abs(len_a - len_b))   # exact int diff
    if flag == F.FEAT_MANHATTAN:
        return w(man)
    if flag == F.FEAT_INTERSECTION:
        # (mag_a + mag_b - man) / (mag_a + mag_b): numerator/denominator
        # are exact ints < 2^25 -> one rounding each; keep EV algebra.
        msum = add(w(mag_a), w(mag_b))
        num = sub(msum, w(man))
        return div(num, msum)
    if flag == F.FEAT_KULCZYNSKI2:
        ap = scale_exact(w(mag_a), 1.0 / V)    # V power of two: exact scale
        aq = scale_exact(w(mag_b), 1.0 / V)
        min_sum = scale_exact(sub(add(w(mag_a), w(mag_b)), w(man)), 0.5)
        coeff = div(scale_exact(add(ap, aq), float(V)),
                    scale_exact(mul(ap, aq), 2.0))
        return mul(coeff, min_sum)
    if flag == F.FEAT_SIMRATIO:
        norm2 = maximum0(sub(add(w(sq_a), w(sq_b)), w(2.0 * dot)))
        return div(w(dot), add(w(dot), sqrt(norm2)))
    if flag == F.FEAT_PEARSON:
        # round(mag/V) half-away-from-zero: mag/V exact (V = 2^2k), +0.5
        # and floor exact => ap/aq are EXACT integers.
        ap = jnp.floor(mag_a / V + 0.5)
        aq = jnp.floor(mag_b / V + 0.5)
        np_ = add(sub(w(sq_a), scale_exact(mul(w(ap), w(mag_a)), 2.0)),
                  scale_exact(mul(w(ap), w(ap)), float(V)))
        nq_ = add(sub(w(sq_b), scale_exact(mul(w(aq), w(mag_b)), 2.0)),
                  scale_exact(mul(w(aq), w(aq)), float(V)))
        dotc = add(sub(sub(w(dot), mul(w(ap), w(mag_b))),
                       mul(w(aq), w(mag_a))),
                   scale_exact(mul(w(ap), w(aq)), float(V)))
        prod = mul(np_, nq_)
        half = EV(jnp.maximum(prod.v, 0.5), prod.e)
        return div(dotc, sqrt(half))
    raise AssertionError(flag)


def score(singles: Sequence[int], combos, mins, spans, is_sim, weights,
          man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b, V: int
          ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Certified classifier evaluation.

    mins/spans/weights are plain-f32 [S]/[C+1] parameter arrays: the f32
    roundings of the f64 values (spans = f32(f64 max - f64 min), like
    ds_classify.const_block). Returns (score, eps_score, f1, eps_f1) with
    |score_f64 - score| <= eps_score (and likewise f1); eps includes the
    SAFETY factor. positive <=> score >= 0 is certain when
    |score| > eps_score."""
    norms = []
    for i, flag in enumerate(singles):
        v = _single(flag, man, dot, mag_a, mag_b, sq_a, sq_b,
                    len_a, len_b, V)
        mn = const(mins[i])
        span = const(spans[i])
        nrm = div(sub(v, mn), span)
        one = exact(jnp.ones_like(nrm.v))
        inv = sub(one, nrm)
        norms.append(EV(jnp.where(is_sim[i], nrm.v, inv.v),
                        jnp.where(is_sim[i], nrm.e, inv.e)))
    s = const(jnp.broadcast_to(weights[0], man.shape))
    f1 = None
    for j, (combo, idx) in enumerate(combos):
        prod = exact(jnp.ones_like(man))
        for i in idx:
            c = norms[i]
            term = mul(c, c) if combo == F.COMBO_SQUARED else c
            prod = mul(prod, term)
        if j == 0:
            f1 = prod
        s = add(s, mul(const(jnp.broadcast_to(weights[j + 1], man.shape)),
                       prod))
    return s.v, s.e * SAFETY, f1.v, f1.e * SAFETY


def exact_floor_div(sum_i32, count_i32):
    """floor(sum/count) for non-negative int32 arrays, exactly.

    The f32 quotient is within 1 ulp of the real one; two integer
    corrections pin the floor. Matches the reference's double-precision
    mean + per-element truncation (DivergencePoint.cpp:53-65): for
    integer ratios with denominator < 2^24 the f64 quotient never rounds
    across an integer, so floor(f64 div) == exact floor."""
    q = jnp.floor(sum_i32.astype(jnp.float32) /
                  count_i32.astype(jnp.float32)).astype(jnp.int32)
    # two rounds: the device's f32 quotient is not correctly rounded and
    # can be ~2 units off near 2^23
    for _ in range(2):
        r = sum_i32 - q * count_i32
        q = jnp.where(r < 0, q - 1, q)
        r = sum_i32 - q * count_i32
        q = jnp.where(r >= count_i32, q + 1, q)
    return q


def distance_d(dist, mg) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """d = 10000*(1 - (dist/mg)^2) with error bound, from EXACT integer
    (dist, mg) f32 arrays (DivergencePoint.cpp:53-65 arithmetic).
    Returns (d, eps_d)."""
    frac = div(exact(dist), exact(jnp.maximum(mg, 1.0)))
    one = exact(jnp.ones_like(dist))
    d = scale_exact(sub(one, mul(frac, frac)), 10000.0)
    return d.v, d.e * SAFETY
