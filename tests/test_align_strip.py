"""The strip aligner kernel (ops/align_strip.py) in interpret mode against
the XLA scan `ops/align.batch_align`, lane for lane and count for count.

On the card the same kernel is compiled through Triton; tests/test_gpu_hw.py
checks it there at 1 kb widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from meshclust_tpu.ops import align as A
from meshclust_tpu.ops.align_strip import LANES, strip_counts


def _batch(rng, l1, l2, La=None, Lb=None, related=0.0, n_rate=0.0):
    """Code matrices for lengths l1/l2; `related` of the pairs copy seq1
    into seq2 with 10% substitutions; `n_rate` of the bases are 'N'."""
    P = len(l1)
    La = La or max(16, int(-(-max(l1) // 16) * 16))
    Lb = Lb or max(16, int(max(l2)))
    a = np.zeros((P, La), np.uint8)
    b = np.zeros((P, Lb), np.uint8)
    for p in range(P):
        a[p, :l1[p]] = rng.integers(0, 4, l1[p])
        b[p, :l2[p]] = rng.integers(0, 4, l2[p])
        if rng.random() < related:
            m = min(l1[p], l2[p])
            b[p, :m] = a[p, :m]
            mut = rng.random(m) < 0.1
            b[p, :m][mut] = (b[p, :m][mut] + 1) % 4
    if n_rate:
        a[rng.random(a.shape) < n_rate] = 78
        b[rng.random(b.shape) < n_rate] = 78
    return a, b, np.asarray(l1, np.int32), np.asarray(l2, np.int32)


def _check(a, b, l1, l2, **kw):
    got = strip_counts(*map(jnp.asarray, (a, b, l1, l2)), interpret=True,
                       **kw)
    La, Lb = a.shape[1], b.shape[1]
    _, alen, amatch, _ = A.batch_align(*map(jnp.asarray, (a, b, l1, l2)),
                                       R=La + 1, D=La + Lb + 1)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(alen))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(amatch))


@pytest.mark.parametrize("lo,hi", [(1, 12), (20, 70), (60, 130)])
def test_random_pairs_match_scan(rng, lo, hi):
    l1 = rng.integers(lo, hi, LANES)
    l2 = rng.integers(lo, hi, LANES)
    _check(*_batch(rng, l1, l2, related=0.5))


def test_asymmetric_lengths(rng):
    """seq1 much longer than seq2 and the reverse, in one block."""
    l1 = np.where(np.arange(LANES) % 2, 150, 9)
    l2 = np.where(np.arange(LANES) % 2, 7, 140)
    _check(*_batch(rng, l1, l2, related=0.5))


def test_identical_pairs(rng):
    l1 = rng.integers(30, 90, LANES)
    a, b, l1, l2 = _batch(rng, l1, l1)
    b[:, : a.shape[1]] = a[:, : b.shape[1]]
    _check(a, b, l1, l2)


def test_boundary_cell_pairs(rng):
    """Empty and one-base sequences end on a boundary cell (or before the
    first diagonal) and take the scan's closed-form readout."""
    l1 = np.zeros(LANES, np.int64)
    l2 = np.zeros(LANES, np.int64)
    l1[:8] = [0, 0, 1, 0, 1, 5, 0, 2]
    l2[:8] = [0, 1, 0, 7, 1, 0, 2, 0]
    l1[8:] = rng.integers(0, 20, LANES - 8)
    l2[8:] = rng.integers(0, 20, LANES - 8)
    _check(*_batch(rng, l1, l2))


def test_n_codes_compare_equal(rng):
    """'N' (78) matches 'N', as the reference's char comparison does."""
    l1 = rng.integers(40, 80, LANES)
    l2 = rng.integers(40, 80, LANES)
    _check(*_batch(rng, l1, l2, related=0.7, n_rate=0.1))


def test_blocks_with_different_bounds(rng):
    """Each program derives its own strip and column bounds: a block of
    short pairs next to a block of long ones, and a block whose l1 spread
    crosses several strips."""
    l1 = np.concatenate([rng.integers(3, 10, LANES),
                         rng.integers(100, 120, LANES),
                         rng.integers(5, 110, LANES)])
    l2 = np.concatenate([rng.integers(3, 10, LANES),
                         rng.integers(90, 125, LANES),
                         rng.integers(5, 110, LANES)])
    _check(*_batch(rng, l1, l2, related=0.5))


def test_pad_lanes_and_blocks(rng):
    """A partial block padded by replicating its last pair, then a whole
    pad block of zero-length pairs, which the kernel sweeps not at all."""
    n = LANES + 5
    l1 = np.zeros(3 * LANES, np.int64)
    l2 = np.zeros(3 * LANES, np.int64)
    l1[:n] = rng.integers(20, 60, n)
    l2[:n] = rng.integers(20, 60, n)
    a, b, l1, l2 = _batch(rng, l1, l2, related=0.5)
    a[n:2 * LANES] = a[n - 1]
    b[n:2 * LANES] = b[n - 1]
    l1[n:2 * LANES] = l1[n - 1]
    l2[n:2 * LANES] = l2[n - 1]
    _check(a, b, l1, l2)


@pytest.mark.parametrize("S", [4, 8])
def test_strip_heights(rng, S):
    """Other strip heights: the readout row falls in other strips."""
    l1 = rng.integers(1, 50, 2 * LANES)
    l2 = rng.integers(1, 50, 2 * LANES)
    _check(*_batch(rng, l1, l2, related=0.5), S=S)


def test_non_default_scoring(rng):
    """Other match/mismatch/gap parameters go through unchanged."""
    l1 = rng.integers(10, 60, LANES)
    l2 = rng.integers(10, 60, LANES)
    a, b, l1, l2 = _batch(rng, l1, l2, related=0.5)
    kw = dict(match=2, mismatch=-3, go=5, gc=2)
    got = strip_counts(*map(jnp.asarray, (a, b, l1, l2)), interpret=True,
                       **kw)
    _, alen, amatch, _ = A.batch_align(
        *map(jnp.asarray, (a, b, l1, l2)), R=a.shape[1] + 1,
        D=a.shape[1] + b.shape[1] + 1, **kw)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(alen))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(amatch))
