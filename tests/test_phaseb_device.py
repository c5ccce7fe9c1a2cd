"""Fused device Phase B (all update+merge iterations in one jitted call)
vs the per-iteration host-orchestrated path: partitions and representatives
must agree (ClusterFactory.cpp:738-753 semantics)."""
import numpy as np
import pytest

from meshclust_tpu.config import ClusterConfig
from meshclust_tpu.core.runner import run
from meshclust_tpu.io.clstr import parse_clstr, partition_labels
from tests.conftest import mutate, random_dna


def _synthetic(rng, n_species=8, per=10, length=400, rate=0.04):
    records = []
    for s in range(n_species):
        base = random_dna(rng, length + int(rng.integers(-25, 25)))
        for c in range(per):
            seq = base if c == 0 else mutate(rng, base, rate)
            records.append((f"sp{s}_c{c}", seq))
    order = rng.permutation(len(records))
    return [records[i] for i in order]


@pytest.mark.slow
def test_fused_phaseb_matches_periter(rng, make_fasta, tmp_path,
                                      monkeypatch):
    records = _synthetic(rng)
    path = make_fasta(records, "pb.fasta")
    out_f = str(tmp_path / "fused.clstr")
    out_p = str(tmp_path / "periter.clstr")

    monkeypatch.setenv("MESHCLUST_FUSED_PHASEB", "1")
    run(ClusterConfig(files=[path], similarity=0.90, output=out_f,
                      iterations=6))
    monkeypatch.setenv("MESHCLUST_FUSED_PHASEB", "0")
    run(ClusterConfig(files=[path], similarity=0.90, output=out_p,
                      iterations=6))

    lf = partition_labels(parse_clstr(out_f))
    lp = partition_labels(parse_clstr(out_p))
    assert set(lf) == set(lp)
    # same partition (cluster ids may be permuted)
    from meshclust_tpu.io.clstr import nmi
    assert nmi(lf, lp) == pytest.approx(1.0)

    # representatives agree cluster-for-cluster
    def reps(path):
        out = set()
        for cl in parse_clstr(path):
            out.update(h for h, is_rep in cl if is_rep)
        return out

    assert reps(out_f) == reps(out_p)


def test_replay_mismatch_counts_a_fallback():
    """A fused Phase B whose device history disagrees with the host replay
    restores the centers, returns None (the caller then runs the host
    path) and counts one fallback, which chip_smoke.py requires to be 0."""
    from meshclust_tpu.core.meanshift import Center, MeanShift
    from meshclust_tpu.utils import perf

    class Backend:
        def phase_b_loop(self, members, assign, centers, delta, iterations):
            # claims one surviving center where the replay keeps two
            return (np.zeros(members.shape[0], np.int64),
                    np.asarray(centers), np.asarray([True, False]),
                    [np.asarray([0, 1])])

    ms = MeanShift(None, Backend(), sim=0.9, delta=1, iterations=1)
    centers = [Center(0, [0, 2]), Center(1, [1, 3])]
    perf.reset()
    assert ms.run_phase_b_device(centers) is None
    assert perf.counters()["phase_b_replay_fallbacks"] == 1
    assert [(c.center, c.members) for c in centers] == [(0, [0, 2]),
                                                        (1, [1, 3])]
