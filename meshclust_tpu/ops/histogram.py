"""Batched k-mer histogram featurization.

Reference semantics (KmerHashTable + fill_table, SURVEY C3/N4):
- dense 4^k direct-addressed count table, initialized to `init`
  (1 for meshclust histograms => +1 pseudocount, KmerHashTable.cpp:32-83),
- rolling hash id(p) = sum_i codes[p+i] * 4^(k-1-i) (KmerHashTable.cpp:106-159),
- only k-mer windows fully inside one segment chunk are counted
  (fill_table, ClusterFactory.h:40-55); the host precomputes that validity
  mask (io.fasta.kmer_valid_starts).

The histogram is a scatter-add of the rolling-hash ids (`histogram_xla`);
the id computation (k shifted multiply-adds) is fused elementwise work. On
an H100 its device time at 1 kb reads was about a third of a one-hot
outer-product matmul formulation's (featurize as a whole is host-bound
either way), so it is the only implementation.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from meshclust_tpu.io import fasta as fio

LANE = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def kmer_ids(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Rolling-hash ids [B, L] from digit codes [B, L] (int32, garbage where
    any window position is invalid — callers mask with `valid`)."""
    codes = jnp.where(codes > 3, 0, codes).astype(jnp.int32)
    L = codes.shape[-1]
    ids = jnp.zeros_like(codes)
    for i in range(k):
        power = 4 ** (k - 1 - i)
        shifted = jnp.concatenate(
            [codes[:, i:], jnp.zeros((codes.shape[0], i), jnp.int32)], axis=1
        ) if i else codes
        ids = ids + shifted * power
    return ids


def histogram_xla(codes: jnp.ndarray, valid: jnp.ndarray, k: int,
                  init: int = 1) -> jnp.ndarray:
    """Scatter-add reference path. codes [B, L] uint8/int32, valid [B, L]
    bool/int32 -> counts [B, 4^k] int32."""
    B, L = codes.shape
    V = 4 ** k
    ids = kmer_ids(codes, k)
    v = valid.astype(jnp.int32)
    flat = (jnp.arange(B, dtype=jnp.int32)[:, None] * V + ids).reshape(-1)
    counts = jnp.zeros((B * V,), jnp.int32).at[flat].add(v.reshape(-1))
    return counts.reshape(B, V) + jnp.int32(init)


@jax.jit
def seq_stats_device(counts: jnp.ndarray):
    """Exact per-sequence (mag, sq_hi, sq_lo) from int counts on device.

    mag = sum(c) <= L + V fits int32. sq = sum(c^2) can exceed int32 (and
    f32's 2^24 exact-integer range), so it is computed as an exact hi/lo
    split: sq = (sum(c^2 >> 16) << 16) + sum(c^2 & 0xFFFF), each partial
    sum bounded by V * 2^16 < 2^31 for V <= 4^7 and c <= 32767 (int8/int16
    storage corpora — wider counts take the host path)."""
    c = counts.astype(jnp.int32)
    mag = jnp.sum(c, axis=1)
    c2 = c * c
    hi = jnp.sum(c2 >> 16, axis=1)
    lo = jnp.sum(c2 & 0xFFFF, axis=1)
    return mag, hi, lo


@jax.jit
def one_mer_counts(codes: jnp.ndarray, in_seg: jnp.ndarray) -> jnp.ndarray:
    """1-mer counts [B, 4] (init 0), ref get_divergence_point's second table
    (ClusterFactory.cpp:996,1001). Counted over in-segment positions."""
    c = codes.astype(jnp.int32)
    m = in_seg.astype(jnp.int32)
    return jnp.stack(
        [jnp.sum((c == i) * m, axis=1) for i in range(4)], axis=1
    )


@functools.partial(jax.jit, static_argnames=("k", "init"))
def featurize_batch_device(codes, valid, inseg, k: int, init: int = 1):
    """One fused device call per bucket: histogram + 1-mers + mag."""
    counts = histogram_xla(codes, valid, k, init=init)
    ones = one_mer_counts(codes, inseg)
    mag = jnp.sum(counts.astype(jnp.int64), axis=1)
    return counts, ones, mag


@functools.partial(jax.jit, static_argnames=("k", "init"))
def featurize_batch_simple(codes, lengths, k: int, init: int = 1):
    """featurize_batch_device for all-single-segment batches: the validity
    masks are derived from lengths on device (2/3 less host-to-device
    traffic)."""
    L = codes.shape[1]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    lengths = lengths.astype(jnp.int32)[:, None]
    valid = (pos < lengths - (k - 1)).astype(jnp.uint8)
    inseg = (pos < lengths).astype(jnp.uint8)
    return featurize_batch_device(codes, valid, inseg, k, init)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Host-side 2-bit packing of digit codes [B, L] (L % 4 == 0, values
    0..3) -> [B, L//4] uint8. Quarters the host-to-device copy."""
    B, L = codes.shape
    v = codes.reshape(B, L // 4, 4)
    return (v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4)
            | (v[:, :, 3] << 6)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("k", "init"))
def featurize_batch_packed(packed, lengths, k: int, init: int = 1):
    """featurize_batch_simple on 2-bit-packed codes (device-side unpack)."""
    p = packed.astype(jnp.int32)
    parts = jnp.stack([(p >> (2 * i)) & 3 for i in range(4)], axis=-1)
    codes = parts.reshape(p.shape[0], p.shape[1] * 4).astype(jnp.uint8)
    return featurize_batch_simple(codes, lengths, k, init)


# ---------------------------------------------------------------------------
# Host-side batch preparation
# ---------------------------------------------------------------------------

def pad_batch(seqs: List[fio.Sequence], k: int, pad_to: int | None = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a list of Sequences to [B, Lpad] (codes, kmer-valid, in-segment).

    Sequences that are one full-length segment (no N runs — the common case)
    get vectorized length-based masks; others take the per-record path."""
    L = max(s.length for s in seqs)
    Lp = pad_to or round_up(max(L, LANE), LANE)
    B = len(seqs)
    codes = np.zeros((B, Lp), np.uint8)
    valid = np.zeros((B, Lp), np.uint8)
    inseg = np.zeros((B, Lp), np.uint8)
    lengths = np.fromiter((s.length for s in seqs), np.int64, count=B)
    simple = np.fromiter(
        ((s.segments.shape[0] == 1 and s.segments[0, 0] == 0
          and s.segments[0, 1] == s.length - 1) for s in seqs),
        bool, count=B)
    for i, s in enumerate(seqs):
        codes[i, : s.length] = s.codes
        if not simple[i]:
            valid[i, : s.length] = fio.kmer_valid_starts(s, k)
            inseg[i, : s.length] = fio.in_segment_mask(s)
    if simple.any():
        pos = np.arange(Lp, dtype=np.int64)[None, :]
        vmask = (pos < (lengths - k + 1)[:, None]) & simple[:, None]
        imask = (pos < lengths[:, None]) & simple[:, None]
        valid |= vmask.astype(np.uint8)
        inseg |= imask.astype(np.uint8)
    return codes, valid, inseg


def length_buckets(lengths: List[int], granularity: int = 256,
                   max_bucket_rows: int = 16384) -> List[List[int]]:
    """Group sequence indices into padded-length buckets to bound padding
    waste and recompilation count."""
    order = np.argsort(np.asarray(lengths, dtype=np.int64), kind="stable")
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_pad = None
    for idx in order:
        pad = round_up(max(int(lengths[idx]), 1), granularity)
        if cur and (pad != cur_pad or len(cur) >= max_bucket_rows):
            buckets.append(cur)
            cur = []
        cur_pad = pad
        cur.append(int(idx))
    if cur:
        buckets.append(cur)
    return buckets


def featurize(seqs: List[fio.Sequence], k: int, init: int = 1,
              mesh=None) -> dict:
    """Featurize all sequences: k-mer histograms (+pseudocount), 1-mer counts,
    pseudo-magnitudes, lengths. Returns numpy arrays in input order.

    Ref: ClusterFactory::build_points + get_divergence_point
    (ClusterFactory.cpp:770-804, 989-1010).

    With `mesh`, batch inputs are device_put sharded on the row axis so XLA
    partitions the histogram work across the mesh with no collectives
    (the OpenMP `parallel for` at ClusterFactory.cpp:785-801, SPMD-style).
    """
    if mesh is not None:
        from jax.sharding import PartitionSpec as _P
        from meshclust_tpu.parallel import dist as _dist

        def _put(x):
            return _dist.put(mesh, _P("data"), x)
        _fetch = _dist.fetch
    else:
        _put = jnp.asarray
        _fetch = np.asarray
    N = len(seqs)
    V = 4 ** k
    lengths = [s.length for s in seqs]
    # Device-resident output on a single device: the [N, V] histogram stays
    # where clustering consumes it and only the narrow per-sequence stats
    # come back; PointSet materializes a host copy lazily for the exact
    # (oracle) paths. A mesh gathers it on the host instead.
    device_resident = mesh is None
    hist = None if device_resident else np.zeros((N, V), np.int32)
    k1 = np.zeros((N, 4), np.int64)
    from meshclust_tpu.utils import perf
    chunks_dev: List = []
    ones_dev: List = []
    chunk_order: List[np.ndarray] = []
    for bucket in length_buckets(lengths):
        Lp = round_up(max(max(lengths[i] for i in bucket), LANE), LANE)
        # row chunk bounded by a ~1 GiB budget of 8 bytes per position,
        # fixed sizes for compile reuse
        max_rows = max(256, min(8192, (1 << 30) // max(1, Lp * 8)))
        max_rows = 1 << (max_rows.bit_length() - 1)
        for s0 in range(0, len(bucket), max_rows):
            chunk = bucket[s0: s0 + max_rows]
            sub = [seqs[i] for i in chunk]
            rows = len(sub)
            rp = 256 if rows <= 256 else round_up(rows, max(256, max_rows))
            all_simple = all(
                s.segments.shape[0] == 1 and s.segments[0, 0] == 0
                and s.segments[0, 1] == s.length - 1 for s in sub)
            if all_simple:
                with perf.phase("feat_pack"):
                    codes = np.zeros((rp, Lp), np.uint8)
                    lens_arr = np.zeros(rp, np.int32)
                    for i, s in enumerate(sub):
                        codes[i, : s.length] = s.codes
                        lens_arr[i] = s.length
                    packed = pack_2bit(codes)
                with perf.phase("feat_device"):
                    counts, ones, _ = featurize_batch_packed(
                        _put(packed), _put(lens_arr), k, init)
            else:
                with perf.phase("feat_pack"):
                    codes, valid, inseg = pad_batch(sub, k, pad_to=Lp)
                    if rp != rows:
                        pad = ((0, rp - rows), (0, 0))
                        codes = np.pad(codes, pad)
                        valid = np.pad(valid, pad)
                        inseg = np.pad(inseg, pad)
                with perf.phase("feat_device"):
                    counts, ones, _ = featurize_batch_device(
                        _put(codes), _put(valid), _put(inseg), k, init)
            if device_resident:
                chunks_dev.append(counts[:rows])
                ones_dev.append(ones[:rows])
                chunk_order.append(np.asarray(chunk, np.int64))
            else:
                with perf.phase("feat_readback"):
                    hist[np.asarray(chunk)] = _fetch(counts)[:rows]
                    k1[np.asarray(chunk)] = _fetch(ones)[:rows]
    if device_resident and not chunks_dev:          # empty corpus
        hist = np.zeros((N, V), np.int32)
        mag = np.zeros(N, np.int64)
        sq = np.zeros(N, np.int64)
        largest = 0
        hist_dev = None
    elif device_resident:
        with perf.phase("feat_stats"):
            perm = np.concatenate(chunk_order)
            inv = jnp.asarray(np.argsort(perm, kind="stable")
                              .astype(np.int32))
            hist_dev = jnp.concatenate(chunks_dev, axis=0)[inv]
            ones_all = jnp.concatenate(ones_dev, axis=0)[inv]
            mag_d, hi_d, lo_d = seq_stats_device(hist_dev)
            largest = int(jnp.max(hist_dev))
            if largest > 32767 or V > 4 ** 7:
                # exact-stat gate (see seq_stats_device): fall back to the
                # host path for wide-count corpora
                hist = np.asarray(hist_dev)
                from meshclust_tpu.ops import features as _F
                st = _F.seq_stats(hist)
                mag, sq = st["mag"], st["sq"]
                hist_dev = None
            else:
                hist = None
                mag = np.asarray(mag_d).astype(np.int64)
                sq = ((np.asarray(hi_d).astype(np.int64) << 16)
                      + np.asarray(lo_d).astype(np.int64))
                # narrow storage dtype on device (Runner.cpp:75-89 scan)
                sdt = storage_dtype(largest)
                if np.dtype(sdt).itemsize < 4:
                    hist_dev = hist_dev.astype(sdt)
            k1 = np.asarray(ones_all).astype(np.int64)
    else:
        with perf.phase("feat_stats"):
            from meshclust_tpu.ops import features as _F
            st = _F.seq_stats(hist)
            mag, sq = st["mag"], st["sq"]
            largest = int(hist.max()) if N else 0
            hist_dev = None
    return {
        "hist": hist,
        "hist_dev": hist_dev,
        "one_mers": k1,
        "mag": mag,
        "sq": sq,
        "largest": largest,
        "lengths": np.asarray(lengths, dtype=np.int64),
        "k": k,
        "V": V,
    }


def find_k(per_file_seqs: List[List[fio.Sequence]]) -> int:
    """Auto k = ceil(log4(avg length)) - 1 with the reference's nested
    integer divisions (Runner.cpp:265-292)."""
    length = 0
    for seqs in per_file_seqs:
        if not seqs:
            continue
        l = 0
        for s in seqs:
            l += s.length
        l //= len(seqs)
        length += l
    length //= max(1, len(per_file_seqs))
    return int(np.ceil(np.log(max(length, 2)) / np.log(4.0))) - 1


def storage_dtype(largest_count: int):
    """Histogram storage dtype thresholds (ref Runner.cpp:75-89 uses u8/u16/
    u32/u64; this storage is signed, so the first step is 127)."""
    if largest_count <= 127:
        return np.int8
    if largest_count <= 32767:
        return np.int16
    if largest_count <= 2 ** 31 - 1:
        return np.int32
    return np.int64
