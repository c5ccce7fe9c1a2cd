"""GPU tier: compile and run the device paths on the card.

Run on the card with:  MESHCLUST_TEST_GPU=1 python -m pytest tests/ -m gpu -q
(`chip_smoke.py` runs it as one of its phases). Every test takes the `gpu`
fixture, which skips it where JAX finds no GPU.

The CPU tier checks the arithmetic (interpret-mode kernel, XLA on the CPU,
numpy oracles); these tests check what the GPU toolchain makes of it: the
Triton lowering of the aligner kernel at real widths, XLA's GPU code for the
double-single decisions, and the precision of the f32 dot products whose
exact integer results the decisions rest on.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _pairs_1kb(rng, n, n_seqs=400):
    """n index pairs over n_seqs sequences of 900-1100 bases, half of them
    mutated copies (10-30% substitutions) of their partner, some 'N'
    runs."""
    codes = []
    for i in range(n_seqs):
        if i % 2 and codes:
            src = codes[-1]
            c = src.copy()
            m = rng.random(c.shape[0]) < 0.1 + 0.2 * rng.random()
            c[m] = (c[m] + 1) % 4
            c = c[: int(rng.integers(900, len(src) + 1))]
        else:
            c = rng.integers(0, 4, int(rng.integers(900, 1101)),
                             dtype=np.uint8)
        if i % 7 == 0:
            c[10:25] = 78
        codes.append(c)
    pairs = [(i - 1, i) if i % 2 else (int(rng.integers(n_seqs)), i)
             for i in rng.integers(1, n_seqs, n)]
    return codes, pairs


def _mk_points(n_species=8, per=8, length=300):
    from meshclust_tpu.core.points import build_points
    from meshclust_tpu.io import fasta
    from tests.conftest import mutate, random_dna
    import __graft_entry__ as g
    rng = np.random.default_rng(7)
    seqs = []
    for s in range(n_species):
        base = random_dna(rng, length + int(rng.integers(-20, 20)))
        for c in range(per):
            seq = base if c == 0 else mutate(rng, base, 0.03)
            seqs.append(fasta.encode_record(f">sp{s}_c{c}", seq.encode()))
    ps = build_points(seqs, k=4)
    _, _, _, _, params = g._toy_model(V=ps.V)
    return ps, params


def test_strip_kernel_matches_scan_at_1kb(gpu):
    """The Triton kernel's counts equal the XLA scan's exactly on a
    3000-pair labeling-sized batch of 1 kb pairs."""
    from meshclust_tpu.ops.align_device import DeviceAligner
    rng = np.random.default_rng(2)
    codes, pairs = _pairs_1kb(rng, 3000)
    kern = DeviceAligner(codes)
    assert kern.kernel
    scan = DeviceAligner(codes, use_kernel=False)
    got = kern.counts(pairs)
    want = scan.counts(pairs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_strip_kernel_edge_lanes(gpu):
    """Boundary-cell and tiny pairs, identical pairs and a partial block,
    straight through `strip_counts` against `batch_align`."""
    from meshclust_tpu.ops import align as A
    from meshclust_tpu.ops.align_strip import LANES, strip_counts
    rng = np.random.default_rng(3)
    P = 3 * LANES
    l1 = rng.integers(0, 200, P)
    l2 = rng.integers(0, 200, P)
    l1[:6] = [0, 0, 1, 5, 1, 0]
    l2[:6] = [0, 5, 0, 1, 1, 1]
    a = np.zeros((P, 208), np.uint8)
    b = np.zeros((P, 208), np.uint8)
    for p in range(P):
        a[p, :l1[p]] = rng.integers(0, 4, l1[p])
        b[p, :l2[p]] = a[p, :l2[p]] if p % 3 == 0 else rng.integers(
            0, 4, l2[p])
    got = strip_counts(*map(jnp.asarray, (a, b, l1, l2)))
    _, alen, amatch, _ = A.batch_align(*map(jnp.asarray, (a, b, l1, l2)),
                                       R=209, D=417)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(alen))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(amatch))


def test_ds_matches_float64_on_hardware(gpu):
    """Double-single classifier decisions on the GPU compile stack equal
    float64 wherever |score| > 1e-10 (DS carries ~2^-48 relative), and f1
    agrees with float64 to 1e-12 absolute and relative."""
    from meshclust_tpu.ops import ds_classify as DSC
    from tests.test_ds import _host_score, _mk_stats
    import __graft_entry__ as g
    rng = np.random.default_rng(5)
    V = 256
    _, _, _, _, params = g._toy_model(V=V)
    man, dot, mag_a, mag_b, sq_a, sq_b, len_a, len_b = _mk_stats(rng, 4096,
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
    clear = np.abs(score64) > 1e-10
    np.testing.assert_array_equal(np.asarray(pos)[clear],
                                  (score64 >= 0)[clear])
    f1ds = np.asarray(f1h, np.float64) + np.asarray(f1l, np.float64)
    np.testing.assert_allclose(f1ds, f164, rtol=1e-12, atol=1e-12)


def test_cw_exact_on_hardware(gpu):
    """The exact truncated mean (floor(sum/count) by integer remainder
    correction) holds on the GPU's f32 divide, at exact and half-way
    quotients."""
    from meshclust_tpu.ops import ds_classify as DSC
    rng = np.random.default_rng(6)
    q = rng.integers(1, 1 << 12, 4096).astype(np.int64)
    n = rng.integers(0, 1 << 11, 4096).astype(np.int64)
    p = n * q + rng.integers(0, 2, 4096) * (q // 2)
    got = np.asarray(DSC.cw_exact(jnp.asarray(p[:, None], jnp.float32),
                                  jnp.asarray(q, jnp.float32)))
    np.testing.assert_array_equal(got[:, 0].astype(np.int64), p // q)


def test_pivot_orders_exact_keys_on_hardware(gpu):
    """Past MESHCLUST_REFSORT_MAX the pivot orders come from device argsorts;
    on the card their keys still equal the float64 host keys, exact-integer
    and FMA-split cases included."""
    from tests.test_trainer import (check_pivot_orders_match_host,
                                    integer_key_points)
    ps = integer_key_points(n=2000)
    check_pivot_orders_match_host(ps, np.arange(0, ps.n, 41))


def test_integer_dots_exact_beyond_tf32(gpu):
    """man/dot of int16-storage histograms with odd counts past 2^11 (TF32
    keeps only 11 significant bits) equal the int64 host sums: the decision
    dots run at HIGHEST precision. Sums stay below f32's 2^24."""
    from meshclust_tpu.ops import features as F
    rng = np.random.default_rng(8)
    ha = rng.integers(0, 20, (64, 256)).astype(np.int16)
    hb = rng.integers(0, 20, (48, 256)).astype(np.int16)
    ha[:, 0] = 2049 + 2 * rng.integers(0, 476, 64)
    hb[:, 0] = 2049 + 2 * rng.integers(0, 476, 48)
    man, dot = F.pair_sums_device(jnp.asarray(ha), jnp.asarray(hb))
    ea = ha.astype(np.int64)
    eb = hb.astype(np.int64)
    assert (ea @ eb.T).max() < 1 << 24
    np.testing.assert_array_equal(np.asarray(dot).astype(np.int64),
                                  ea @ eb.T)
    np.testing.assert_array_equal(
        np.asarray(man).astype(np.int64),
        np.abs(ea[:, None, :] - eb[None, :, :]).sum(-1))


def test_featurize_on_hardware(gpu):
    """The scatter histogram on the card equals a numpy count."""
    from meshclust_tpu.ops import histogram as H
    rng = np.random.default_rng(0)
    B, L, k = 64, 1024, 4
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(k, L, size=B).astype(np.int32)
    got = np.asarray(H.featurize_batch_simple(
        jnp.asarray(codes), jnp.asarray(lengths), k, 1)[0])
    ref = np.ones((B, 4 ** k), np.int64)
    for b in range(B):
        ids = np.zeros(lengths[b] - k + 1, np.int64)
        for j in range(k):
            ids = ids * 4 + codes[b, j: lengths[b] - k + 1 + j]
        np.add.at(ref[b], ids, 1)
    np.testing.assert_array_equal(got, ref)


def test_accumulate_device_compiles(gpu):
    from meshclust_tpu.core.accumulate_device import accumulate_device
    from meshclust_tpu.core.bvec import BVec
    ps, params = _mk_points(n_species=8, per=8)
    bv = BVec(ps.lengths.copy(), 32)
    for i in range(ps.n):
        bv.insert(i, int(ps.lengths[i]))
    bv.insert_finalize()
    centers = accumulate_device(ps, bv, params, sim=0.90)
    assert sum(len(c.members) for c in centers) == ps.n


def test_phase_b_device_compiles(gpu):
    from meshclust_tpu.core.classify import DeviceBackend
    ps, params = _mk_points(n_species=6, per=8)
    be = DeviceBackend(ps, params)
    members = np.arange(ps.n)
    assign = np.sort(np.arange(ps.n) % 6).astype(np.int64)
    center_rows = np.arange(6) * 10
    a, ci, cv, th = be.phase_b_loop(members, assign, center_rows,
                                    delta=2, iterations=3)
    assert cv.any()
    assert th.shape[0] == 3


def test_device_backend_get_close_compiles(gpu):
    from meshclust_tpu.core.classify import DeviceBackend
    ps, params = _mk_points(n_species=6, per=8)
    be = DeviceBackend(ps, params)
    marks, is_min, best = be.get_close(0, np.arange(1, 50))
    assert marks.shape == (49,)


def test_fused_probe_rounds_match_unfused(gpu):
    """Trainer.split's fused speculative probe rounds on the kernel pick
    the same training pairs as probing one round at a time."""
    from meshclust_tpu.core.points import build_points
    from meshclust_tpu.core.trainer import Trainer
    from meshclust_tpu.io import fasta
    from meshclust_tpu.ops.align_device import DeviceAligner
    from tests.conftest import mutate, random_dna
    rng = np.random.default_rng(23)
    seqs = []
    for s in range(10):
        base = random_dna(rng, 200 + int(rng.integers(-30, 30)))
        for c in range(20):
            seq = base if c == 0 else mutate(rng, base, 0.05)
            seqs.append(fasta.encode_record(f">p{s}_{c}", seq.encode()))
    ps = build_points(seqs, k=3)

    def make():
        tr = Trainer(ps, n_points=120, cutoff=0.90, max_pts_from_one=20,
                     k=3)
        tr._dev_aligner = DeviceAligner(ps.codes)
        assert tr._dev_aligner.kernel
        return tr

    pairs_fused = make().split()
    tr_plain = make()
    # a caller-supplied align_batch turns the fused rounds off
    tr_plain.align_batch = lambda pairs: tr_plain._default_align_batch(pairs)
    assert make()._probe_aligner() is not None
    assert tr_plain.split() == pairs_fused
