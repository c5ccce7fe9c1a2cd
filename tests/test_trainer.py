"""Trainer pipeline units: balancing, binning, rounding, training gates."""
import math

import numpy as np
import pytest

from meshclust_tpu.core import trainer as T


def test_cxx_round():
    assert T._cxx_round(0.5) == 1
    assert T._cxx_round(1.5) == 2
    assert T._cxx_round(2.5) == 3      # C++ rounds half away from zero
    assert T._cxx_round(-0.5) == -1
    assert T._cxx_round(2.4) == 2


def test_resize_vec_identity():
    vec = [((1, 2), 0.95), ((3, 4), 0.92)]
    out = T.resize_vec(vec, 2, 0.9, 1.0, 5)
    assert out == vec


def test_resize_vec_downsample_takes_from_top_bins():
    vec = [((i, i + 100), 0.90 + 0.001 * i) for i in range(100)]
    out = T.resize_vec(vec, 10, 0.9, 1.0, 5)
    assert len(out) >= 10
    # top-bin items (identity >= 0.98) must be present
    top = [pr for pr, x in out if x >= 0.98]
    assert top


def test_resize_vec_can_overshoot_with_duplicates():
    # faithful to Trainer.cpp:231-240: while-loop refills from bin prefixes
    vec = [((i, i + 10), 0.91) for i in range(3)]   # all in one bin
    out = T.resize_vec(vec, 7, 0.9, 1.0, 5)
    assert len(out) >= 7
    keys = [pr for pr, _ in out]
    # bin prefixes are re-taken each pass: duplicates, not full coverage
    assert len(set(keys)) < len(keys)


def test_bin_data_alternation():
    vec = [((i, i + 10), 0.90 + 0.01 * (i % 10)) for i in range(40)]
    train, test = T.bin_data(vec, 0.9, 1.0)
    assert len(train) + len(test) == 40
    assert abs(len(train) - len(test)) <= 10


def integer_key_points(n=160, V=8, mag=300, seed=11):
    """A PointSet whose pair keys 10000*(1 - (dist/600)^2) are often exact
    integers (dist a multiple of 6), the case a float64 floor rounds one
    below (DivergencePoint.cpp:79-81 is FMA-contracted) and an inexact
    device floor can miss."""
    from meshclust_tpu.core.points import PointSet
    rng = np.random.default_rng(seed)
    hist = np.stack([rng.multinomial(mag, rng.dirichlet(np.full(V, 2.0)))
                     for _ in range(n)]).astype(np.uint16)
    return PointSet(hist=hist, mag=hist.sum(1).astype(np.int64),
                    sq=(hist.astype(np.int64) ** 2).sum(1),
                    lengths=np.full(n, 400, np.int64),
                    one_mers=np.zeros((n, 4), np.int64),
                    headers=[f">s{i}" for i in range(n)],
                    codes=[np.zeros(400, np.uint8)] * n, k=2, V=V)


def check_pivot_orders_match_host(ps, rows):
    """The device path's sort keys equal the float64 host keys, and its
    pivot orders (the path past MESHCLUST_REFSORT_MAX) equal a stable
    argsort of them, row for row."""
    keys = np.stack([ps.distance_row(int(r)) for r in rows]).astype(np.int64)
    np.testing.assert_array_equal(ps.distance_rows_device(rows), keys)
    tr = T.Trainer(ps, n_points=40, cutoff=0.9, max_pts_from_one=10, k=ps.k)
    got = np.asarray(tr._pivot_orders(rows).orders_dev)
    for i in range(len(rows)):
        np.testing.assert_array_equal(got[i],
                                      np.argsort(keys[i], kind="stable"))


def test_pivot_orders_use_exact_keys():
    ps = integer_key_points()
    dist = 2 * np.minimum(ps.hist[:, None], ps.hist[None]).astype(
        np.int64).sum(-1)
    # the inputs hold the FMA case (1e4*(1 - (462/600)^2) = 4071 floors to
    # 4070 in the reference) and many other exact-integer keys
    assert (dist == 462).any() and ((dist % 6) == 0).mean() > 0.2
    assert ps.distance(*map(int, np.argwhere(dist == 462)[0])) == 4070
    check_pivot_orders_match_host(ps, np.arange(0, ps.n, 7))


def test_get_bin_bounds():
    assert T._get_bin(1.5, 0.0, 1.0, 10) == 9
    assert T._get_bin(-1.0, 0.0, 1.0, 10) == 0
    assert T._get_bin(0.55, 0.0, 1.0, 10) == 5
