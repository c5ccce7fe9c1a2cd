"""Double-single arithmetic (ops/ds.py) and the DS classifier/distance
(ops/ds_classify.py): decisions must match the float64 host oracle,
including adversarial near-boundary inputs where plain f32 flips."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from meshclust_tpu.ops import ds
from meshclust_tpu.ops import ds_classify as DSC
from meshclust_tpu.ops import features as F


def _rand_pairs(rng, n):
    a = rng.uniform(-1e6, 1e6, n).astype(np.float64)
    b = rng.uniform(-1e6, 1e6, n).astype(np.float64)
    return a, b


def _ds_of(x):
    hi, lo = ds.from_f64(x)
    return jnp.asarray(hi), jnp.asarray(lo)


def test_ds_ops_match_float64(rng):
    n = 4096
    a64, b64 = _rand_pairs(rng, n)
    a, b = _ds_of(a64), _ds_of(b64)
    scale = np.maximum(np.abs(a64), np.abs(b64))
    for name, op, ref, sc in (
        # add/sub: error is ~2^-48 of the INPUT scale (catastrophic
        # cancellation shrinks the result, not the absolute error)
        ("add", ds.add, a64 + b64, scale),
        ("sub", ds.sub, a64 - b64, scale),
        ("mul", ds.mul, a64 * b64, np.abs(a64 * b64)),
        ("div", ds.div, a64 / b64, np.abs(a64 / b64)),
    ):
        got = ds.to_f64(tuple(np.asarray(x) for x in op(a, b)))
        rel = np.abs(got - ref) / np.maximum(sc, 1e-300)
        assert rel.max() < 1e-13, (name, rel.max())
    s64 = np.abs(a64)
    got = ds.to_f64(tuple(np.asarray(x) for x in ds.sqrt(_ds_of(s64))))
    rel = np.abs(got - np.sqrt(s64)) / np.sqrt(s64)
    assert rel.max() < 1e-13


def test_ds_floor_rational_means(rng):
    """floor of p/q rationals (q < 2^24) must equal the exact floor — the
    distance_d guarantee. Floored means come from the integer-corrected
    `cw_exact`, never from flooring a DS quotient (a divide that is not
    correctly rounded puts exact quotients a hair below the integer)."""
    q = rng.integers(1, 1 << 12, 4096).astype(np.int64)
    n = rng.integers(0, 1 << 11, 4096).astype(np.int64)
    p = n * q + rng.integers(0, 2, 4096) * (q // 2)   # exact or mid, < 2^24
    got = np.asarray(DSC.cw_exact(jnp.asarray(p[:, None], jnp.float32),
                                  jnp.asarray(q, jnp.float32)))
    got = got[:, 0].astype(np.int64)
    want = p // q
    np.testing.assert_array_equal(got, want)


def _mk_stats(rng, n, V=256):
    """Random integer statistics in the f32-exact regime."""
    mag_a = rng.integers(V, 4 * V, n).astype(np.float64)
    mag_b = rng.integers(V, 4 * V, n).astype(np.float64)
    man = rng.integers(0, (mag_a + mag_b)).astype(np.float64)
    sq_a = rng.integers(V, 40 * V, n).astype(np.float64)
    sq_b = rng.integers(V, 40 * V, n).astype(np.float64)
    dot = rng.integers(0, np.minimum(sq_a, sq_b)).astype(np.float64)
    len_a = rng.integers(100, 2000, n).astype(np.float64)
    len_b = rng.integers(100, 2000, n).astype(np.float64)
    return man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b


def _host_score(params, man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b,
                V):
    cols = [F.raw_from_sums(f, man=man, dot=dot, mag_a=mag_a, mag_b=mag_b,
                            sq_a=sq_a, sq_b=sq_b, len_a=len_a, len_b=len_b,
                            V=V) for f in params.singles]
    cache = np.stack(cols, axis=-1)
    norm = (cache - params.mins) / (params.maxs - params.mins)
    norm = np.where(params.is_sim, norm, 1.0 - norm)
    score = np.full(man.shape[0], params.weights[0])
    f1 = None
    for j, (combo, idx) in enumerate(params.combos):
        prod = np.ones(man.shape[0])
        for i in idx:
            c = norm[:, i]
            prod = prod * (c * c if combo == F.COMBO_SQUARED else c)
        if j == 0:
            f1 = prod
        score = score + params.weights[j + 1] * prod
    return score, f1


def test_ds_classifier_matches_float64(rng):
    import __graft_entry__ as g
    V = 256
    _, _, _, _, params = g._toy_model(V=V)
    man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b = _mk_stats(rng, 8192,
                                                                 V)
    score64, f164 = _host_score(params, man, dot, mag_a, mag_b, sq_a, sq_b,
                                len_a, len_b, V)
    cb = DSC.const_block(params)
    f32 = lambda x: jnp.asarray(x, jnp.float32)   # noqa: E731

    @jax.jit
    def run(man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b):
        return DSC.score(tuple(params.singles),
                         tuple((c, tuple(i)) for c, i in params.combos),
                         jnp.asarray(cb["mins2"]), jnp.asarray(cb["spans2"]),
                         jnp.asarray(cb["is_sim"]),
                         jnp.asarray(cb["weights2"]),
                         man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b,
                         V)

    pos, f1h, f1l = run(f32(man), f32(dot), f32(mag_a), f32(mag_b),
                        f32(sq_a), f32(sq_b), f32(len_a), f32(len_b))
    pos = np.asarray(pos)
    # decision agreement everywhere the float64 score is not ridiculously
    # close to zero (DS precision ~1e-14 relative)
    clear = np.abs(score64) > 1e-10
    np.testing.assert_array_equal(pos[clear], (score64 >= 0)[clear])
    assert clear.mean() > 0.99
    # f1 agrees to DS precision
    f1ds = np.asarray(f1h, np.float64) + np.asarray(f1l, np.float64)
    np.testing.assert_allclose(f1ds, f164, rtol=1e-12, atol=1e-12)


def test_ds_distance_matches_mean_select(rng):
    """distance_d_from_cw vs the float64 mean_select math on random
    members."""
    V = 64
    M = 500
    h = rng.integers(1, 100, size=(M, V)).astype(np.int64)
    members = np.arange(M)
    # float64 oracle (core/meanshift.mean_select internals)
    c = h.sum(axis=0) / M
    cw = np.floor(c).astype(np.int64)
    dist = 2 * np.minimum(h, cw[None, :]).sum(axis=1)
    mag = np.floor(h.astype(np.float64) + c[None, :]).sum(axis=1)
    frac = dist.astype(np.float64) / mag
    d64 = 10000.0 * (1.0 - frac * frac)

    sums = jnp.asarray(h.sum(axis=0), jnp.float32)
    cwe = DSC.cw_exact(sums, jnp.float32(M))
    dh, dl = DSC.distance_d_from_cw(jnp.asarray(h, jnp.float32),
                                    cwe[None, :])
    dds = np.asarray(dh, np.float64) + np.asarray(dl, np.float64)
    np.testing.assert_allclose(dds, d64, rtol=1e-11, atol=1e-11)
    # argmin (the decision) must agree exactly
    assert int(np.argmin(dds)) == int(np.argmin(d64))


def test_cw_exact_at_integer_means(rng):
    """Exact-integer lane means are the adversarial case: a device f32
    divide that is not correctly rounded (the GPU's is not) can land
    ~2^-44 BELOW an exact integer quotient, and a naive DS floor then comes
    out one low, flipping get_mean winners. cw_exact must pin every lane
    to the true rational floor."""
    for cnt in (7, 98, 1000, 16383):
        V = 128
        q_true = rng.integers(0, 200, V).astype(np.int64)
        rem = rng.integers(0, cnt, V).astype(np.int64)
        rem[::3] = 0                      # a third exactly divisible
        sums = q_true * cnt + rem
        cw = np.asarray(DSC.cw_exact(jnp.asarray(sums, jnp.float32),
                                     jnp.float32(cnt)))
        np.testing.assert_array_equal(cw.astype(np.int64), sums // cnt)
    # large-quotient regime (quotient near 2^23 / count 1)
    sums = (np.arange(100) + (1 << 23) - 50).astype(np.int64)
    cw = np.asarray(DSC.cw_exact(jnp.asarray(sums, jnp.float32),
                                 jnp.float32(1.0)))
    np.testing.assert_array_equal(cw.astype(np.int64), sums)
