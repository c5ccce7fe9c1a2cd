"""DeviceAligner (ops/align_device.py): staging, bucketing, lane padding and
the choice between the kernel and the XLA scan, against the scalar oracle.

The kernel route runs here through the Pallas interpreter; on the card the
GPU tier (tests/test_gpu_hw.py) runs it compiled.
"""
import functools

import numpy as np
import pytest

from meshclust_tpu.ops import align_device as AD
from meshclust_tpu.ops import align_strip as AS
from tests import ref_impl


def _codes(rng, n, n_prob=0.0):
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    if n_prob:
        c[rng.random(n) < n_prob] = 78
    return c


def _oracle(codes, pairs):
    out = [ref_impl.glob_align(codes[a], codes[b]) for a, b in pairs]
    return (np.asarray([o[1] for o in out]), np.asarray([o[2] for o in out]))


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Take the kernel route on the CPU, through the Pallas interpreter."""
    monkeypatch.setattr(AD, "kernel_available", lambda: True)
    monkeypatch.setattr(AS, "strip_counts", functools.partial(
        AS.strip_counts, interpret=True))
    AD._align_staged.clear_cache()
    yield
    AD._align_staged.clear_cache()


def test_device_aligner_cpu_fallback(rng):
    """On the CPU test backend, identities() runs the XLA scan and matches
    the oracle."""
    codes = [_codes(rng, int(rng.integers(20, 90))) for _ in range(12)]
    al = AD.DeviceAligner(codes)
    assert not al.kernel
    pairs = [(i, (i + 3) % 12) for i in range(12)]
    got = al.identities(pairs)
    for t, (ia, ib) in enumerate(pairs):
        _, el, em, _ = ref_impl.glob_align(codes[ia], codes[ib])
        assert abs(got[t] - em / max(el, 1)) < 1e-12


def test_kernel_route_matches_oracle(rng, interpret_kernel):
    """The kernel route end to end: staging, row buckets (several), sorted
    blocks, tail-lane replication and pad blocks."""
    codes = ([_codes(rng, int(rng.integers(5, 60)), 0.05) for _ in range(30)]
             + [_codes(rng, int(rng.integers(70, 140)), 0.05)
                for _ in range(10)])
    pairs = [(int(rng.integers(40)), int(rng.integers(40)))
             for _ in range(2 * AS.LANES + 7)]
    al = AD.DeviceAligner(codes)
    assert al.kernel
    alen, amatch = al.counts(pairs)
    el, em = _oracle(codes, pairs)
    np.testing.assert_array_equal(alen, el)
    np.testing.assert_array_equal(amatch, em)


@pytest.mark.parametrize("use_kernel,available,expect", [
    (True, True, True), (False, True, False), (True, False, False)])
def test_aligner_choice(monkeypatch, use_kernel, available, expect):
    """The kernel runs only where it can compile and the caller allows it
    (use_kernel=False gives the tests' scan reference)."""
    monkeypatch.setattr(AD, "kernel_available", lambda: available)
    assert AD.DeviceAligner([np.zeros(5, np.uint8)],
                            use_kernel=use_kernel).kernel is expect


def _capture(monkeypatch):
    calls = []

    def fake(codes, ia, ib, l1, l2, *, La, Lb, kernel, **kw):
        calls.append(dict(ia=np.asarray(ia), ib=np.asarray(ib),
                          l1=np.asarray(l1), l2=np.asarray(l2), La=La, Lb=Lb,
                          kernel=kernel))
        return np.asarray(l1), np.zeros(len(ia), np.int32)

    monkeypatch.setattr(AD, "_align_staged", fake)
    monkeypatch.setattr(AD, "kernel_available", lambda: True)
    return calls


def test_kernel_chunk_padding(rng, monkeypatch):
    """A kernel chunk is a pow2 number of LANES blocks; the tail block's
    pad lanes replicate the longest pair and whole pad blocks carry zero
    lengths."""
    calls = _capture(monkeypatch)
    codes = [_codes(rng, int(rng.integers(100, 120))) for _ in range(20)]
    n = 3 * AS.LANES + 5
    pairs = [(int(rng.integers(20)), int(rng.integers(20))) for _ in range(n)]
    alen, _ = AD.DeviceAligner(codes).counts(pairs)
    (c,) = calls
    assert c["kernel"] and c["ia"].shape[0] == 4 * AS.LANES
    assert c["La"] % AS.STRIP == 0 and c["La"] >= 120 and c["Lb"] == 128
    s = c["l1"][:n] + c["l2"][:n]
    assert np.all(np.diff(s) >= 0)                   # sorted blocks
    assert np.all(c["l1"][n:] == c["l1"][n - 1])     # tail replicates
    assert np.all(c["ia"][n:] == c["ia"][n - 1])
    # results land back in caller order
    lens = np.asarray([len(x) for x in codes])
    np.testing.assert_array_equal(alen, lens[[a for a, _ in pairs]])


def test_pad_blocks_sweep_nothing(rng, monkeypatch):
    calls = _capture(monkeypatch)
    codes = [_codes(rng, 50) for _ in range(4)]
    n = 2 * AS.LANES + 1                             # 3 blocks -> 4
    AD.DeviceAligner(codes).counts([(0, 1)] * n)
    (c,) = calls
    assert c["ia"].shape[0] == 4 * AS.LANES
    assert np.all(c["l1"][3 * AS.LANES:] == 0)
    assert np.all(c["l2"][3 * AS.LANES:] == 0)


def test_long_pairs_take_the_scan(monkeypatch):
    """Pairs past the kernel's packing limit go to the XLA scan, chosen by
    shape; the others in the same call keep the kernel."""
    calls = _capture(monkeypatch)
    long = np.zeros(AS.PACK_LIMIT // 2 + 10, np.uint8)
    short = np.zeros(300, np.uint8)
    al = AD.DeviceAligner([long, short])
    al.counts([(0, 0), (1, 1), (1, 0)])
    routes = {(c["La"], bool(c["kernel"])) for c in calls}
    assert any(not k for _, k in routes)              # long rows: scan
    assert any(k for _, k in routes)                  # short rows: kernel
    for c in calls:
        if c["kernel"]:
            assert (c["l1"] + c["l2"]).max() + 2 <= AS.PACK_LIMIT


@pytest.mark.parametrize("x,want", [(1, 64), (64, 64), (65, 128),
                                    (1000, 1024), (1100, 1280),
                                    (5000, 5120)])
def test_bucket_rows(x, want):
    """Quarter-octave row buckets: at most ~25% padding."""
    assert AD._bucket_rows(x) == want


def test_stage_budget():
    """The staged corpus gets a share of what the device reports; the CPU
    (host memory) has no budget and an accelerator without a limit is an
    error."""
    class Dev:
        platform = "gpu"
        device_kind = "fake"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    assert AD.stage_budget_bytes() is None            # CPU test backend
    assert AD.stage_budget_bytes(Dev({"bytes_limit": 1000})) == 400
    with pytest.raises(RuntimeError):
        AD.stage_budget_bytes(Dev({}))
    with pytest.raises(RuntimeError):
        AD.stage_budget_bytes(Dev(None))
