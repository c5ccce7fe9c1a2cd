"""Batched GlobAlignE identities addressed by sequence index.

The corpus' codes are staged on the device once ([N, Lpad] int8), so a call
ships only pair indices and lengths. Pairs are grouped by row-length bucket,
sorted by combined length (homogeneous blocks), gathered on device, and
aligned by one of two implementations of the same DP (reference
GlobAlignE.cpp:123-292):

- `ops/align_strip.strip_counts`, the Pallas kernel (Triton route), when
  the device is a CUDA GPU (`DeviceAligner(use_kernel=False)` turns it off,
  for the tests' and chip_smoke's reference);
- `ops/align.batch_align`, the XLA anti-diagonal scan, otherwise, and for
  pairs beyond the kernel's (len << 16) | matches packing limit.

Counts are exact int32 (alignment length, matches); the float64 division
happens on host like the reference's getIdentity (GlobAlignE.cpp:301-305).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meshclust_tpu.ops import align as A
from meshclust_tpu.ops import align_strip as AS

# Pairs per dispatch: the kernel takes a pow2 number of LANES-pair blocks up
# to this; the scan one fixed batch (one compiled program per bucket).
_KERNEL_CHUNK = 4096
_SCAN_CHUNK = 512
# Share of the device memory the staged corpus may take.
_STAGE_SHARE = 0.4


def kernel_available() -> bool:
    """Pallas' Triton route lowers for CUDA devices only."""
    return jax.devices()[0].platform == "gpu"


def stage_budget_bytes(device=None):
    """Bytes the staged corpus may take on `device`: a share of the limit
    the device reports. None on the CPU, whose arrays live in host memory;
    an accelerator that reports no limit is an error."""
    device = device or jax.devices()[0]
    stats = device.memory_stats()
    if stats is None and device.platform == "cpu":
        return None
    if not stats or not stats.get("bytes_limit"):
        raise RuntimeError(
            f"{device.device_kind} reports no memory limit "
            "(memory_stats()['bytes_limit']); cannot size the aligner's "
            "staged corpus")
    return int(stats["bytes_limit"] * _STAGE_SHARE)


def _bucket_rows(x: int) -> int:
    """Quarter-octave bucket for the DP row axis (<=25% pad waste)."""
    if x <= 64:
        return 64
    step = max(64, (1 << (int(x - 1).bit_length() - 1)) // 4)
    return ((x + step - 1) // step) * step


def _bucket_pow2(x: int, lo: int = 1) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _take(codes, idx, L: int):
    """Rows `idx` of the staged codes, cut or zero-padded to L columns."""
    x = jnp.take(codes, idx, axis=0)
    if L <= codes.shape[1]:
        return x[:, :L]
    return jnp.pad(x, ((0, 0), (0, L - codes.shape[1])))


@functools.partial(jax.jit, static_argnames=(
    "La", "Lb", "kernel", "match", "mismatch", "go", "gc"))
def _align_staged(codes, ia, ib, l1, l2, *, La: int, Lb: int, kernel: bool,
                  match: int, mismatch: int, go: int, gc: int):
    """(alen, amatch) for pairs (ia, ib) of the staged corpus: device-side
    gather, then the kernel or the scan."""
    a = _take(codes, ia, La)
    b = _take(codes, ib, Lb)
    if kernel:
        return AS.strip_counts(a, b, l1, l2, match=match, mismatch=mismatch,
                               go=go, gc=gc)
    _, alen, amatch, _ = A.batch_align(a, b, l1, l2, R=La + 1,
                                       D=La + Lb + 1, match=match,
                                       mismatch=mismatch, go=go, gc=gc)
    return alen, amatch


class DeviceAligner:
    """Batched GlobAlignE identities addressed by sequence index.

    codes: per-sequence uint8 digit arrays ('N' kept as 78 — N==N matches,
    ref ChromosomeOneDigit semantics). use_kernel=False keeps every pair on
    the XLA scan.
    """

    def __init__(self, codes: List[np.ndarray], match: int = 1,
                 mismatch: int = -1, go: int = 2, gc: int = 1,
                 use_kernel: bool = True):
        self.codes = codes
        self.lengths = np.asarray([len(c) for c in codes], np.int64)
        self.match, self.mismatch, self.go, self.gc = match, mismatch, go, gc
        self.kernel = use_kernel and kernel_available()
        self._staged = None     # codes_dev [N, Lpad] int8

    def _stage(self):
        if self._staged is None:
            lmax = int(self.lengths.max()) if len(self.codes) else 8
            lpad = ((max(lmax, 8) + 127) // 128) * 128
            N = len(self.codes)
            budget = stage_budget_bytes()
            if budget is not None and N * lpad > budget:
                raise MemoryError(
                    f"aligner corpus [{N}, {lpad}] int8 exceeds its device "
                    f"budget of {budget} bytes")
            mat = np.zeros((N, lpad), np.int8)
            for i, c in enumerate(self.codes):
                mat[i, : len(c)] = c
            self._staged = jax.device_put(mat)
        return self._staged

    def identities(self, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
        """Float64 identities for (index_a, index_b) pairs (exact host
        division of exact int32 match/length counts)."""
        if len(pairs) == 0:
            return np.zeros(0, np.float64)
        from meshclust_tpu.utils import perf
        with perf.phase("align"):
            alen, amatch = self.counts(pairs)
        return amatch.astype(np.float64) / np.maximum(
            alen.astype(np.float64), 1.0)

    def counts(self, pairs: Sequence[Tuple[int, int]]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact (alignment_length, matches) int64 arrays."""
        n = len(pairs)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ia = np.asarray([p for p, _ in pairs], np.int64)
        ib = np.asarray([q for _, q in pairs], np.int64)
        l1 = self.lengths[ia]
        l2 = self.lengths[ib]
        from meshclust_tpu.utils import perf
        perf.add("nw_cells", float((l1 * l2).sum()))
        perf.add("nw_pairs", n)
        codes_dev = self._stage()
        groups: dict = {}
        for t in range(n):
            groups.setdefault(_bucket_rows(int(l1[t])), []).append(t)
        # Dispatch every chunk before reading any result back, so the
        # readback of one chunk overlaps the next chunk's compute.
        pending = []
        for ba, idxs in groups.items():
            idxs.sort(key=lambda t: int(l1[t] + l2[t]))
            sel = np.asarray(idxs)
            bb = _bucket_pow2(int(l2[sel].max()), 64)
            # chosen by shape: the kernel's packed lanes hold l1 + l2 only
            # up to PACK_LIMIT; longer pairs take the scan
            kernel = (self.kernel
                      and int((l1[sel] + l2[sel]).max()) + 2 <= AS.PACK_LIMIT)
            step = _KERNEL_CHUNK if kernel else _SCAN_CHUNK
            for s in range(0, len(sel), step):
                chunk = sel[s: s + step]
                pending.append((chunk, *self._run_chunk(
                    ia[chunk], ib[chunk], l1[chunk], l2[chunk], ba, bb,
                    kernel, codes_dev)))
        alen = np.zeros(n, np.int64)
        amatch = np.zeros(n, np.int64)
        for chunk, al, am in pending:
            m = len(chunk)
            alen[chunk] = np.asarray(al, np.int64)[:m]
            amatch[chunk] = np.asarray(am, np.int64)[:m]
        return alen, amatch

    def _run_chunk(self, ia, ib, l1, l2, ba: int, bb: int, kernel: bool,
                   codes_dev):
        """Dispatch one chunk; returns the device (alen, amatch) un-read."""
        n = len(ia)
        if kernel:
            # pow2 block count bounds compiles; lanes n..nfull of the tail
            # block replicate its last (longest) pair so the block's bounds
            # stay those of its real lanes, and whole pad blocks carry
            # l1 = l2 = 0, for which the kernel sweeps nothing
            nblocks = (n + AS.LANES - 1) // AS.LANES
            P = _bucket_pow2(nblocks) * AS.LANES
            nfull = nblocks * AS.LANES
            La = ((ba + AS.STRIP - 1) // AS.STRIP) * AS.STRIP
        else:
            P = max(_SCAN_CHUNK, n)
            nfull = P
            La = ba
        pia = np.zeros(P, np.int32)
        pib = np.zeros(P, np.int32)
        pl1 = np.zeros(P, np.int32)
        pl2 = np.zeros(P, np.int32)
        for arr, src in ((pia, ia), (pib, ib), (pl1, l1), (pl2, l2)):
            arr[:n] = src
            arr[n:nfull] = src[-1]
        return _align_staged(
            codes_dev, jnp.asarray(pia), jnp.asarray(pib), jnp.asarray(pl1),
            jnp.asarray(pl2), La=La, Lb=bb, kernel=kernel, match=self.match,
            mismatch=self.mismatch, go=self.go, gc=self.gc)
