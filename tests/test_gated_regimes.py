"""Characterize the documented parity-gate fallbacks (round-4 verdict #7):
beyond MESHCLUST_REFSORT_MAX the trainer uses stable argsort tie orders
instead of the libstdc++ introsort replay, and with MESHCLUST_FORCE_F32
every device decision is plain f32 instead of certified/DS. Both are
documented tie-breaking-level divergences — these tests pin that the
output drift they cause is bounded (partition NMI vs the exact path
> 0.99), instead of asserting it in PARITY.md only."""
import numpy as np
import pytest

from meshclust_tpu.config import ClusterConfig
from meshclust_tpu.core.runner import run
from meshclust_tpu.io.clstr import nmi, parse_clstr, partition_labels
from tests.conftest import mutate, random_dna


def _corpus(rng, n_species=10, per=60, length=260):
    records = []
    for s in range(n_species):
        base = random_dna(rng, length + int(rng.integers(-8, 8)))
        for c in range(per):
            seq = base if c == 0 else mutate(rng, base, 0.04)
            records.append((f"g{s}_c{c}", seq))
    order = rng.permutation(len(records))
    return [records[i] for i in order]


def _labels(path, out, **env):
    import os
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        run(ClusterConfig(files=[path], similarity=0.90, output=out))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return partition_labels(parse_clstr(out))


@pytest.mark.slow
def test_refsort_gate_drift_bounded(rng, make_fasta, tmp_path):
    """Crossing MESHCLUST_REFSORT_MAX switches pivot-sort tie orders to
    stable argsort (trainer.py); the sampled training pairs can differ,
    but the partition must stay essentially identical."""
    path = make_fasta(_corpus(rng), "gate.fasta")
    exact = _labels(path, str(tmp_path / "a.clstr"))
    gated = _labels(path, str(tmp_path / "b.clstr"),
                    MESHCLUST_REFSORT_MAX=1)
    score = nmi(exact, gated)
    print(f"refsort-gate drift NMI={score:.4f}")
    assert score > 0.99


@pytest.mark.slow
def test_f32_gate_drift_bounded(rng, make_fasta, tmp_path):
    """The f32 fallback (inputs beyond f32-exactness; forced here via
    MESHCLUST_FORCE_F32) may flip boundary-tie decisions only — the
    partition must stay essentially identical to the certified path."""
    path = make_fasta(_corpus(rng), "gate32.fasta")
    exact = _labels(path, str(tmp_path / "a.clstr"))
    gated = _labels(path, str(tmp_path / "b.clstr"),
                    MESHCLUST_FORCE_F32=1)
    score = nmi(exact, gated)
    print(f"f32-gate drift NMI={score:.4f}")
    assert score > 0.99
