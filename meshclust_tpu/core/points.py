"""PointSet: the dense array-of-structs replacement for Point/DivergencePoint.

Reference: Point.h / DivergencePoint.{h,cpp} (SURVEY C6). One object per
sequence becomes column arrays over all sequences:
  hist [N, 4^k] int  (pseudo-counted k-mer histogram; ref `points` vector)
  mag  [N] int64     (pseudo-magnitude = sum of counts)
  sq   [N] int64     (sum of squared counts — powers the derived statistics)
  lengths [N] int64  (nucleotide length incl. Ns; ref get_length())
  one_mers [N, 4]
  headers  list[str] (full '>'-lines)
  codes    list[np.uint8 arrays] (digit codes + literal 'N's; ref data_str)
ids are assigned in FASTA order AFTER training (Runner.cpp:346-349) and equal
the row index here from the start — the reference's late assignment only
matters for its align-cache keys, which we key by row index throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from meshclust_tpu.io import fasta as fio
from meshclust_tpu.ops import histogram as H
from meshclust_tpu.ops import features as F


def _fma_1_minus_sq(frac):
    """gcc-contracted `1.0 - frac * frac`, i.e. fma(-frac, frac, 1.0):
    ONE rounding of (1 - frac^2) instead of two.

    The reference is compiled -O3 (-ffp-contract=fast), so
    DivergencePoint::distance truncates 10000 * fma(-frac, frac, 1.0)
    (DivergencePoint.cpp:79-81) — for dist=462, mag=600 that is 4070,
    while the naive two-rounding form gives 4071; four such keys
    reordered a 20k pivot sort and changed one sampled training pair
    (round-5 parity find). Emulated in vectorized f64 with a Dekker
    two_prod residual; exact up to a ~2^-107 tie that integer-ratio
    fracs (denominator < 2^24) cannot produce."""
    frac = np.asarray(frac, np.float64)
    p = frac * frac
    split = np.float64((1 << 27) + 1)
    c = split * frac
    hi = c - (c - frac)
    lo = frac - hi
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo   # p + e == frac^2
    t = 1.0 - p
    terr = (1.0 - t) - p                            # exact residual
    return t + (terr - e)


@dataclasses.dataclass
class PointSet:
    hist: Optional[np.ndarray]        # host histogram (lazy when on-device)
    mag: np.ndarray
    sq: np.ndarray
    lengths: np.ndarray
    one_mers: np.ndarray
    headers: List[str]
    codes: List[np.ndarray]
    k: int
    V: int
    hist_dev: Optional[object] = None  # device [N, V] (storage dtype)
    largest: int = 0                   # max k-mer count (dtype-scan input)

    def __post_init__(self):
        assert self.hist is not None or self.hist_dev is not None

    def __getattribute__(self, name):
        # Lazy host materialization: featurization keeps the histogram on
        # device; the exact/oracle paths that index `ps.hist` trigger ONE
        # full fetch on first use.
        if name == "hist":
            h = object.__getattribute__(self, "hist")
            if h is None:
                h = np.asarray(object.__getattribute__(self, "hist_dev"))
                object.__setattr__(self, "hist", h)
            return h
        return object.__getattribute__(self, name)

    @property
    def n(self) -> int:
        return int(self.lengths.shape[0])

    def hist_rows(self, idx: np.ndarray) -> np.ndarray:
        """Host copies of histogram rows `idx` WITHOUT materializing the
        full host histogram: device gather + small D2H when the histogram
        is device-resident."""
        h = object.__getattribute__(self, "hist")
        if h is not None:
            return h[idx]
        import jax.numpy as jnp
        dev = object.__getattribute__(self, "hist_dev")
        return np.asarray(dev[jnp.asarray(np.asarray(idx, np.int32))])

    def distance(self, i: int, j: int) -> int:
        """DivergencePoint::distance (uint64-truncated), used by the trainer's
        pivot sorts (DivergencePoint.cpp:68-81)."""
        dist = 2 * int(np.minimum(self.hist[i], self.hist[j])
                       .astype(np.int64).sum())
        mag = int(self.mag[i] + self.mag[j])
        frac = np.float64(dist) / np.float64(mag)
        return int(10000.0 * _fma_1_minus_sq(frac))

    def distance_row(self, i: int) -> np.ndarray:
        """distance(i, :) vectorized (float64 frac, truncated to int)."""
        dist = 2 * np.minimum(self.hist[i][None, :], self.hist)\
            .astype(np.int64).sum(axis=1)
        mag = (self.mag[i] + self.mag).astype(np.float64)
        frac = dist.astype(np.float64) / mag
        return (10000.0 * _fma_1_minus_sq(frac)).astype(np.uint64)

    # -- cached device copies (shared by trainer + classify backends) ------
    def device_arrays(self) -> dict:
        import jax.numpy as jnp
        if not hasattr(self, "_dev"):
            hdev = object.__getattribute__(self, "hist_dev")
            if hdev is None:
                # hist kept in its (narrow) storage dtype on device too;
                # every consumer casts gathered rows to f32 (fuses into the
                # gather).
                hdt = self.hist.dtype if self.hist.dtype.itemsize <= 4 \
                    else np.float32
                hdev = jnp.asarray(self.hist, hdt)
            self._dev = {
                "hist": hdev,
                "mag": jnp.asarray(self.mag, jnp.float32),
                "sq": jnp.asarray(self.sq, jnp.float32),
                "len": jnp.asarray(self.lengths, jnp.float32),
            }
        return self._dev

    def distance_rows_device(self, rows: np.ndarray) -> np.ndarray:
        """DivergencePoint::distance for [P] pivots vs all points.

        Where the integer statistics are f32-exact, the DEVICE computes
        only the exact integer Manhattan row sums; the frac division,
        10000*(1-frac^2), and the truncating uint cast run on the HOST in
        real float64 — bit-identical to `distance_row` and to the
        reference's double path (DivergencePoint.cpp:68-81) by
        construction. (The previous double-single device readout was
        ~2^-44-accurate, which flipped the trailing floor near integer
        values and changed pivot sort orders — 41/1458 training pairs
        diverged at 20k; round-5 parity find.) Non-exact regimes keep the
        plain-f32 device fallback (documented drift)."""
        from meshclust_tpu.ops import ds as _ds
        exact = _ds.ds_inputs_exact(int(self.mag.max()),
                                    int(self.sq.max()))
        import jax.numpy as jnp
        dev = self.device_arrays()
        if not exact:
            if not hasattr(self, "_distfn"):
                self._distfn = _get_distfn()
            parts = []
            for s in range(0, rows.shape[0], 64):
                chunk = rows[s: s + 64]
                parts.append(self._distfn(
                    dev["hist"], dev["mag"],
                    chunk.astype(np.int32)).astype(jnp.int16))
            stacked = parts[0] if len(parts) == 1 else jnp.concatenate(
                parts)
            return np.asarray(stacked).astype(np.int64)
        if not hasattr(self, "_manfn"):
            self._manfn = _get_manfn()
        # man <= mag_i + mag_j: ship int16 when it fits (half the
        # device-to-host copy), fetched in ONE readback
        narrow = 2 * int(self.mag.max()) < (1 << 15)
        parts = []
        for s in range(0, rows.shape[0], 64):
            chunk = rows[s: s + 64]
            man = self._manfn(dev["hist"], chunk.astype(np.int32))
            parts.append(man.astype(jnp.int16) if narrow else man)
        stacked = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        man = np.asarray(stacked).astype(np.float64)
        msum = (self.mag[rows][:, None] + self.mag[None, :]).astype(
            np.float64)
        frac = (msum - man) / msum
        return (10000.0 * _fma_1_minus_sq(frac)).astype(np.uint64)\
            .astype(np.int64)


def _man_rows(hist, rows):
    """Manhattan distances [P, N] (exact integers in f32) of rows `rows`
    against every row of hist [N, V]. One [N, V] reduction per pivot in a
    loop: XLA:GPU took 7 minutes to compile the equivalent single
    [P, N, V] broadcast-reduce fusion at N = 150k, P = 64 (H100)."""
    import jax
    import jax.numpy as jnp
    hist = hist.astype(jnp.float32)
    return jax.lax.map(
        lambda r: jnp.sum(jnp.abs(hist - hist[r][None, :]), axis=-1), rows)


def _make_distfn():
    """Plain-f32 DivergencePoint::distance rows, for statistics that are
    not f32-exact (documented drift)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def distfn(hist, mag, rows):
        man = _man_rows(hist, rows)                  # [P, N]
        msum = mag[rows][:, None] + mag[None, :]
        frac = (msum - man) / msum                   # 2*min_sum/msum
        return jnp.floor(10000.0 * (1.0 - frac * frac))

    return distfn


_DISTFN: list = []


def _get_distfn():
    if not _DISTFN:
        _DISTFN.append(_make_distfn())
    return _DISTFN[0]


def _make_manfn():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def manfn(hist, rows):
        return _man_rows(hist, rows).astype(jnp.int32)   # [P, N] exact

    return manfn


_MANFN: list = []


def _get_manfn():
    if not _MANFN:
        _MANFN.append(_make_manfn())
    return _MANFN[0]


def build_points(seqs: List[fio.Sequence], k: int, mesh=None) -> PointSet:
    """Featurize all sequences (ref ClusterFactory::build_points +
    get_divergence_point). Without a mesh the histogram stays
    device-resident (feats["hist_dev"]); the host copy is lazy."""
    feats = H.featurize(seqs, k, mesh=mesh)
    hist = feats["hist"]
    if hist is not None:
        # apply the dtype scan to STORAGE (ref Runner.cpp:75-89 dispatches
        # do_run<u8|u16|u32|u64> on the max count): 4x memory at 1M scale
        hist = hist.astype(H.storage_dtype(feats["largest"]))
    return PointSet(
        hist=hist,
        mag=feats["mag"],
        sq=feats["sq"],
        lengths=feats["lengths"],
        one_mers=feats["one_mers"],
        headers=[s.header for s in seqs],
        codes=[s.codes for s in seqs],
        k=k,
        V=feats["V"],
        hist_dev=feats["hist_dev"],
        largest=feats["largest"],
    )
