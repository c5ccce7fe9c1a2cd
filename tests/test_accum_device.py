"""Device-resident accumulate vs the host bvec-emulation path."""
import numpy as np
import pytest

from meshclust_tpu.core import classify as C
from meshclust_tpu.core.bvec import BVec
from meshclust_tpu.core.meanshift import MeanShift
from meshclust_tpu.core.points import build_points
from meshclust_tpu.io import fasta
from tests.conftest import mutate, random_dna


def _pointset(rng, n_species=8, per=10, length=400, rate=0.03):
    seqs = []
    for s in range(n_species):
        base = random_dna(rng, length + int(rng.integers(-20, 20)))
        for c in range(per):
            seq = base if c == 0 else mutate(rng, base, rate)
            seqs.append(fasta.encode_record(f">sp{s}_c{c}", seq.encode()))
    order = rng.permutation(len(seqs))
    return build_points([seqs[i] for i in order], k=4)


def _params(ps):
    import __graft_entry__ as g
    _, _, _, _, params = g._toy_model(V=ps.V)
    return params


def _fresh_bv(ps):
    bv = BVec(ps.lengths.copy(), 20)
    for i in range(ps.n):
        bv.insert(i, int(ps.lengths[i]))
    bv.insert_finalize()
    return bv


def test_device_accumulate_matches_host(rng):
    ps = _pointset(rng)
    params = _params(ps)
    be = C.DeviceBackend(ps, params)
    ms = MeanShift(ps, be, sim=0.90, delta=3, iterations=1)

    from meshclust_tpu.core.accumulate_device import accumulate_device
    centers_dev = accumulate_device(ps, _fresh_bv(ps), params, 0.90)

    be2 = C.DeviceBackend(ps, params)
    be2.supports_device_accumulate = False
    ms_host = MeanShift(ps, be2, sim=0.90, delta=3, iterations=1)
    centers_host = ms_host.accumulate_all(_fresh_bv(ps))

    assert len(centers_dev) == len(centers_host)
    for cd, ch in zip(centers_dev, centers_host):
        assert cd.center == ch.center
        assert cd.members == ch.members


def test_device_accumulate_partitions_everything(rng):
    ps = _pointset(rng, n_species=5, per=6, length=300)
    params = _params(ps)
    from meshclust_tpu.core.accumulate_device import accumulate_device
    centers = accumulate_device(ps, _fresh_bv(ps), params, 0.90)
    all_members = sorted(m for c in centers for m in c.members)
    assert all_members == list(range(ps.n))
    for c in centers:
        assert c.center in c.members


def test_device_accumulate_with_compaction_matches_host(rng, monkeypatch):
    """Force live-set bucket compaction (tiny min bucket + tiny center
    chunks) and assert the result is still member-for-member identical to
    the host path — compaction must be semantically invisible."""
    monkeypatch.setenv("MESHCLUST_ACCUM_MINBUCKET", "8")
    monkeypatch.setenv("MESHCLUST_ACCUM_CHUNK", "2")
    monkeypatch.setenv("MESHCLUST_ACCUM_COMPACT", "1")  # small-N gate off
    ps = _pointset(rng, n_species=8, per=10, length=300)
    params = _params(ps)
    from meshclust_tpu.core.accumulate_device import accumulate_device
    centers_dev = accumulate_device(ps, _fresh_bv(ps), params, 0.90)

    be2 = C.DeviceBackend(ps, params)
    be2.supports_device_accumulate = False
    ms_host = MeanShift(ps, be2, sim=0.90, delta=3, iterations=1)
    centers_host = ms_host.accumulate_all(_fresh_bv(ps))

    assert len(centers_dev) == len(centers_host)
    for cd, ch in zip(centers_dev, centers_host):
        assert cd.center == ch.center
        assert cd.members == ch.members


@pytest.mark.parametrize("seed2", [11, 12])
def test_certified_mode_equals_ds_mode(rng, seed2, monkeypatch):
    """'cert' (certified f32 + DS fallback conds) must reproduce the 'ds'
    (always double-single) partition bit-for-bit — same owners, stamps,
    centers — on corpora with duplicate sequences and near-boundary
    pairs."""
    import numpy as np
    r = np.random.default_rng(seed2)
    ps = _pointset(r, n_species=6, per=9, length=350, rate=0.08)
    params = _params(ps)
    from meshclust_tpu.core.accumulate_device import accumulate_device

    monkeypatch.setenv("MESHCLUST_EXACT_MODE", "ds")
    centers_ds = accumulate_device(ps, _fresh_bv(ps), params, 0.90)
    monkeypatch.setenv("MESHCLUST_EXACT_MODE", "cert")
    centers_ct = accumulate_device(ps, _fresh_bv(ps), params, 0.90)

    assert len(centers_ds) == len(centers_ct)
    for cd, cc in zip(centers_ds, centers_ct):
        assert cd.center == cc.center
        assert cd.members == cc.members


def test_certified_mode_with_duplicates(rng, monkeypatch):
    """Exact duplicate sequences tie every statistic; the cert path must
    break ties like ds (first in insertion order) WITHOUT firing the DS
    fallback for the duplicate-only ties."""
    import numpy as np
    from meshclust_tpu.io import fasta
    from meshclust_tpu.core.points import build_points
    from meshclust_tpu.utils import perf
    r = np.random.default_rng(99)
    seqs = []
    for s in range(4):
        base = random_dna(r, 300)
        for c in range(8):
            # half the members are exact duplicates of the seed
            seq = base if c % 2 == 0 else mutate(r, base, 0.05)
            seqs.append(fasta.encode_record(f">sp{s}_c{c}", seq.encode()))
    order = r.permutation(len(seqs))
    ps = build_points([seqs[i] for i in order], k=4)
    params = _params(ps)
    from meshclust_tpu.core.accumulate_device import accumulate_device

    monkeypatch.setenv("MESHCLUST_EXACT_MODE", "ds")
    centers_ds = accumulate_device(ps, _fresh_bv(ps), params, 0.90)
    monkeypatch.setenv("MESHCLUST_EXACT_MODE", "cert")
    perf.reset()
    centers_ct = accumulate_device(ps, _fresh_bv(ps), params, 0.90)
    fb = perf.counters()
    for cd, cc in zip(centers_ds, centers_ct):
        assert cd.center == cc.center
        assert cd.members == cc.members
    # duplicates alone must not trigger argmin fallbacks
    assert fb.get("accum_fb_argmin", 0) == 0
