"""Histogram featurization vs the scalar fill_table oracle."""
import jax.numpy as jnp
import numpy as np
import pytest

from meshclust_tpu.io import fasta
from meshclust_tpu.ops import histogram as H
from tests import ref_impl


def _host_hist(feats):
    """The histogram on the host, wherever featurize left it."""
    if feats["hist"] is not None:
        return feats["hist"]
    return np.asarray(feats["hist_dev"])


def _rand_seq(rng, n, with_n=False):
    alphabet = "ACGTN" if with_n else "ACGT"
    p = [0.23, 0.23, 0.23, 0.23, 0.08] if with_n else None
    return "".join(rng.choice(list(alphabet), size=n, p=p))


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("with_n", [False, True])
def test_histogram_matches_oracle(rng, k, with_n):
    seqs = [
        fasta.encode_record(f">s{i}", _rand_seq(rng, int(rng.integers(40, 300)),
                                                with_n).encode())
        for i in range(12)
    ]
    feats = H.featurize(seqs, k)
    hist = _host_hist(feats)
    for i, s in enumerate(seqs):
        oracle = ref_impl.hist_oracle(s.codes, s.segments, k, init=1)
        np.testing.assert_array_equal(hist[i], oracle)
        assert feats["mag"][i] == oracle.sum()


def test_one_mers(rng):
    seqs = [fasta.encode_record(">s", b"ACGTACGTACGTACGTACGTNNNNNNNNNNNNAAAA"
                                      b"CCCCGGGGTTTTACGTACGT")]
    feats = H.featurize(seqs, 2)
    # 1-mers counted over in-segment positions only, init 0
    # (the trailing 20bp segment [32,55] counts; leading 20bp [0,19] counts)
    s = seqs[0]
    inseg = fasta.in_segment_mask(s)
    expect = [int(((s.codes == c) & inseg).sum()) for c in range(4)]
    np.testing.assert_array_equal(feats["one_mers"][0], expect)


def test_find_k():
    # one file, 10 seqs of length 1000 -> avg 1000, k = ceil(log4 1000)-1 = 4
    class S:  # minimal stub
        length = 1000

    assert H.find_k([[S()] * 10]) == 4


def test_short_sequence_counts_nothing():
    # < 20bp -> no segments -> histogram is pure pseudocounts
    s = fasta.encode_record(">tiny", b"ACGTACGTACGT")
    feats = H.featurize([s], 3)
    np.testing.assert_array_equal(_host_hist(feats)[0],
                                  np.ones(64, np.int32))


def test_length_buckets():
    lengths = [100, 5000, 120, 130, 4999, 256]
    buckets = H.length_buckets(lengths, granularity=256)
    all_idx = sorted(i for b in buckets for i in b)
    assert all_idx == list(range(6))
    for b in buckets:
        pads = {H.round_up(max(lengths[i], 1), 256) for i in b}
        assert len(pads) == 1
