"""End-to-end clustering on synthetic data: species must be recovered."""
import numpy as np
import pytest

from meshclust_tpu.config import ClusterConfig
from meshclust_tpu.core.runner import run
from meshclust_tpu.io.clstr import (nmi, one_to_one_recovery, parse_clstr,
                                    partition_labels)
from tests.conftest import mutate, random_dna


def _synthetic(rng, n_species=12, per=15, length=600, rate=0.03):
    records = []
    truth = {}
    for s in range(n_species):
        base = random_dna(rng, length + int(rng.integers(-30, 30)))
        for c in range(per):
            h = f"sp{s}_c{c}"
            seq = base if c == 0 else mutate(rng, base, rate)
            records.append((h, seq))
            truth[">" + h] = s
    order = rng.permutation(len(records))
    return [records[i] for i in order], truth


@pytest.mark.slow
def test_cluster_recovery(rng, make_fasta, tmp_path):
    records, truth = _synthetic(rng)
    path = make_fasta(records, "synth.fasta")
    out = str(tmp_path / "out.clstr")
    cfg = ClusterConfig(files=[path], similarity=0.90, output=out,
                        iterations=5)
    res = run(cfg)
    clusters = parse_clstr(out)
    labels = partition_labels(clusters)
    assert len(labels) == len(records)
    score = nmi(labels, truth)
    recov = one_to_one_recovery(labels, truth)
    print(f"NMI={score:.4f} 1-1={recov:.3f} nclust={res['n_clusters']}")
    assert score > 0.95
    assert recov > 0.8


@pytest.mark.slow
def test_exact_and_device_paths_agree(rng, make_fasta, tmp_path):
    records, truth = _synthetic(rng, n_species=6, per=8, length=400)
    path = make_fasta(records, "synth2.fasta")
    out1 = str(tmp_path / "dev.clstr")
    out2 = str(tmp_path / "exact.clstr")
    run(ClusterConfig(files=[path], similarity=0.90, output=out1,
                      iterations=3))
    run(ClusterConfig(files=[path], similarity=0.90, output=out2,
                      iterations=3, exact=True))
    la = partition_labels(parse_clstr(out1))
    lb = partition_labels(parse_clstr(out2))
    assert nmi(la, lb) > 0.99
