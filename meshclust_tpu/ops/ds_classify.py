"""Double-single classifier scoring shared by every device kernel site.

Mirrors the float64 expression tree of the host oracle
(features.raw_from_sums + HostBackend.classify) op-for-op in double-single
arithmetic (ops/ds.py), so the fused device programs make the SAME decisions
as the reference's double-precision code (Trainer.cpp:115-127) — the
round-2 f32 boundary flips disappear.

Inputs are the exact integer-valued f32 statistics (man, dot, mag, sq,
len); exactness is gated by ds.ds_inputs_exact at backend build time.
Division by V is exact (V = 4^k is a power of two), so PEARSON's
round(mag/V) needs no DS.

Also provides the double-single distance_d (DivergencePoint.cpp:53-65
semantics: mean histogram in double, per-element truncation) used by the
mean-argmin steps.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from meshclust_tpu.ops import ds
from meshclust_tpu.ops import features as F


def const_block(params) -> dict:
    """Host-side DS constants for a FeatureParams: stacked [2, .] arrays
    (row 0 = hi, row 1 = lo) ready to pass into jitted programs."""
    mins = np.asarray(params.mins, np.float64)
    maxs = np.asarray(params.maxs, np.float64)
    spans = maxs - mins                      # f64 subtraction, like the host
    w = np.asarray(params.weights, np.float64)

    def stack(x):
        hi, lo = ds.from_f64(x)
        return np.stack([hi, lo])

    return {
        "mins2": stack(mins),
        "spans2": stack(spans),
        "weights2": stack(w),
        "is_sim": np.asarray(params.is_sim, bool),
    }


def _single(flag: int, man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b,
            V: int):
    """One raw single-feature value as a DS pair (raw_from_sums mirror)."""
    w = ds.wrap
    if flag == F.FEAT_LD:
        return w(jnp.abs(len_a - len_b))
    if flag == F.FEAT_MANHATTAN:
        return w(man)
    if flag == F.FEAT_INTERSECTION:
        # min_sum = (mag_a + mag_b - man)/2; v = 2*min_sum/(mag_a+mag_b)
        # numerator 2*min_sum = mag_a + mag_b - man: exact ints via EFT
        msum = ds.add(w(mag_a), w(mag_b))
        num = ds.sub(msum, w(man))
        return ds.div(num, msum)
    if flag == F.FEAT_KULCZYNSKI2:
        ap = ds.div(w(mag_a), w(jnp.float32(V)))
        aq = ds.div(w(mag_b), w(jnp.float32(V)))
        min_sum = ds.scale(ds.sub(ds.add(w(mag_a), w(mag_b)), w(man)), 0.5)
        coeff = ds.div(ds.mul(w(jnp.float32(V)), ds.add(ap, aq)),
                       ds.scale(ds.mul(ap, aq), 2.0))
        return ds.mul(coeff, min_sum)
    if flag == F.FEAT_SIMRATIO:
        norm2 = ds.sub(ds.add(w(sq_a), w(sq_b)), w(2.0 * dot))
        zero = ds.wrap(jnp.zeros_like(norm2[0]))
        norm2 = ds.maximum(norm2, zero)
        return ds.div(w(dot), ds.add(w(dot), ds.sqrt(norm2)))
    if flag == F.FEAT_PEARSON:
        # mag/V is exact (V = power of two); round is f64-identical
        # C++ round(): half away from zero (mag/V > 0 => floor(x+0.5))
        ap = jnp.floor(mag_a / V + 0.5)
        aq = jnp.floor(mag_b / V + 0.5)
        np_ = ds.add(ds.sub(w(sq_a), ds.scale(ds.mul(w(ap), w(mag_a)), 2.0)),
                     ds.mul(w(jnp.float32(V)), ds.mul(w(ap), w(ap))))
        nq_ = ds.add(ds.sub(w(sq_b), ds.scale(ds.mul(w(aq), w(mag_b)), 2.0)),
                     ds.mul(w(jnp.float32(V)), ds.mul(w(aq), w(aq))))
        dotc = ds.add(
            ds.sub(ds.sub(w(dot), ds.mul(w(ap), w(mag_b))),
                   ds.mul(w(aq), w(mag_a))),
            ds.mul(w(jnp.float32(V)), ds.mul(w(ap), w(aq))))
        prod = ds.mul(np_, nq_)
        half = ds.wrap(jnp.full_like(prod[0], 0.5))
        return ds.div(dotc, ds.sqrt(ds.maximum(half, prod)))
    raise AssertionError(flag)


def score(singles: Sequence[int], combos, mins2, spans2, is_sim, weights2,
          man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b, V: int):
    """DS classifier evaluation.

    Returns (positive bool, f1_hi, f1_lo): positive <=> score >= 0 in
    double-single; f1 is the first combo column as a DS pair for
    lexicographic argmax (the reference compares doubles).
    """
    norms = []
    for i, flag in enumerate(singles):
        v = _single(flag, man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b,
                    V)
        mn = (mins2[0, i], mins2[1, i])
        sp = (spans2[0, i], spans2[1, i])
        nrm = ds.div(ds.sub(v, mn), sp)
        one = ds.wrap(jnp.ones_like(nrm[0]))
        inv = ds.sub(one, nrm)
        norms.append(ds.where(is_sim[i], nrm, inv))
    s = (jnp.broadcast_to(weights2[0, 0], man.shape),
         jnp.broadcast_to(weights2[1, 0], man.shape))
    f1 = None
    for j, (combo, idx) in enumerate(combos):
        prod = ds.wrap(jnp.ones_like(man))
        for i in idx:
            c = norms[i]
            term = ds.mul(c, c) if combo == F.COMBO_SQUARED else c
            prod = ds.mul(prod, term)
        if j == 0:
            f1 = prod
        wj = (weights2[0, j + 1], weights2[1, j + 1])
        s = ds.add(s, ds.mul(wj, prod))
    return ds.ge_zero(s), f1[0], f1[1]


def cw_exact(sums, counts):
    """floor(sums/counts) EXACTLY for integer-valued f32 inputs. Never floor
    a DS quotient instead: the device's f32 divide is not correctly
    rounded, so DS.div of an EXACT integer quotient can land ~2^-44 BELOW
    the integer and floor one too low, which flips get_mean winners. Integer
    remainder corrections pin the f32 quotient estimate (which may be off
    by a couple of ulps on the device) to the true rational floor. Equals the
    reference's double mean + per-element truncation
    (DivergencePoint.cpp:53-65): a f64 quotient of ints with denominator
    < 2^24 never rounds across an integer."""
    c = jnp.maximum(counts, 1.0)
    s_i = sums.astype(jnp.int32)
    c_i = c.astype(jnp.int32)[..., None]
    q = jnp.floor(sums / c[..., None]).astype(jnp.int32)
    for _ in range(2):      # quotient estimate can be ~2 units off at 2^23
        r = s_i - q * c_i
        q = jnp.where(r < 0, q - 1, q)
        r = s_i - q * c_i
        q = jnp.where(r >= c_i, q + 1, q)
    return q.astype(jnp.float32)


def distance_d_from_cw(h, cw):
    """distance_d of integer rows h [.., V] vs an EXACT truncated mean cw
    (from `cw_exact`), per DivergencePoint.cpp:53-65:
      dist = 2 * sum(min(h, cw))
      mag  = sum(floor(h + mean)) = sum(h) + sum(cw)   (h integer)
      d    = 10000 * (1 - (dist/mag)^2)
    Returns (d_hi, d_lo). dist/mag are exact ints; only the final
    frac/d arithmetic is DS (~2^-44 of the real value)."""
    cw_b = jnp.broadcast_to(cw, h.shape)
    dist = 2.0 * jnp.sum(jnp.minimum(h, cw_b), axis=-1)
    mg = jnp.sum(h, axis=-1) + jnp.sum(cw_b, axis=-1)
    return distance_d_scalars(dist, mg)


def distance_d_scalars(dist, mg):
    """The DS frac/d arithmetic of `distance_d_from_cw` from already-
    reduced exact integer (dist, mag) scalars — the V-reductions happen at
    the caller (where a feature-sharded mesh psums per-shard partials,
    core/accumulate_device.py)."""
    frac = ds.div(ds.wrap(dist), ds.wrap(jnp.maximum(mg, 1.0)))
    one = ds.wrap(jnp.ones_like(frac[0]))
    return ds.scale(ds.sub(one, ds.mul(frac, frac)), 10000.0)


def distance_d(h, mean_sum, count):
    """distance_d vs the mean mean_sum/count, exact-cw path."""
    return distance_d_from_cw(h, cw_exact(mean_sum, count))
