"""Batched affine-gap global alignment identity (GlobAlignE re-design).

Reference: GlobAlignE::findAlignment (GlobAlignE.cpp:123-292) — a two-column
rolling DP with 9 lanes: score/length/identity x {match, upperGap, lowerGap},
with fixed tie-break priorities:
  upper:  gap-begin over gap-continue              (GlobAlignE.cpp:186-193)
  match:  matched > xgapEnd(lower) > ygapEnd(upper) (GlobAlignE.cpp:207-241)
  lower:  gap-begin over gap-continue              (GlobAlignE.cpp:258-273)
  final:  matches > lowerGap > upperGap            (GlobAlignE.cpp:278-291)
identity = totalMatches / alignmentLength (GlobAlignE.cpp:301-305).

Exact cell recurrences (verified against the scalar code; (i,j) 1-based,
cell (i,j) aligns seq1[i-1] with seq2[j-1], s = match/mismatch score):

    UG(i,j) = max(M(i,j-1) - go - gc, UG(i,j-1) - gc)
    M(i,j)  = s + max(M(i-1,j-1), LG(i-1,j-1), UG(i-1,j-1))   [priority M,LG,UG]
    LG(i,j) = max(M(i-1,j) - go - gc, LG(i-1,j) - gc)

All three depend only on anti-diagonals d-1 and d-2, so this layout is a
wavefront: state arrays indexed by row i, scanned over diagonals d, batched
over P pairs -> [P, R] tiles per step. It is the plain XLA reference; the
GPU kernel with the same semantics is ops/align_strip.py.

N bytes (78) compare equal to each other, matching the reference's char
comparison on encoded strings.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

def neg_inf_sentinel(l1: jnp.ndarray, l2: jnp.ndarray, mismatch: int,
                     go: int, gc: int) -> jnp.ndarray:
    """The reference's finite 'negativeInf' (GlobAlignE.cpp:125-135).

    l1/l2 are the sequence LENGTHS (the C++ len1/len2 are length+1).
    """
    shorter = jnp.minimum(l1, l2)
    len_diff = jnp.abs(l2 - l1)
    base = mismatch * shorter - 1
    return jnp.where(len_diff >= 1, base - go - len_diff * gc, base)


@functools.partial(jax.jit, static_argnames=("R", "D", "match", "mismatch",
                                             "go", "gc"))
def batch_align(seq1: jnp.ndarray, seq2: jnp.ndarray, l1: jnp.ndarray,
                l2: jnp.ndarray, R: int, D: int, match: int = 1,
                mismatch: int = -1, go: int = 2, gc: int = 1):
    """Align P pairs. seq1 [P, R-1] uint8 codes (padded), seq2 [P, L2max],
    l1/l2 [P] true lengths. R = max_l1 + 1 rows; D = max_l1 + max_l2 + 1.

    Returns (score, align_len, matches, identity) each [P].
    """
    P = seq1.shape[0]
    L2max = seq2.shape[1]
    i32 = jnp.int32
    l1 = l1.astype(i32)
    l2 = l2.astype(i32)
    neg = neg_inf_sentinel(l1, l2, mismatch, go, gc)[:, None]  # [P,1]

    rows = jax.lax.broadcasted_iota(i32, (P, R), 1)            # i index
    # A[p, i] = seq1[p, i-1] for i>=1
    A = jnp.concatenate([jnp.zeros((P, 1), jnp.int32),
                         seq1.astype(jnp.int32)], axis=1)      # [P, R]
    # brev_pad for the reversed diagonal gather of seq2:
    # B_d[i] = seq2[d-1-i] = brev[L2max - d + i], valid for 0 <= d-1-i < l2
    brev = jnp.flip(seq2.astype(jnp.int32), axis=1)            # [P, L2max]
    brev_pad = jnp.concatenate(
        [jnp.zeros((P, R), jnp.int32), brev, jnp.zeros((P, R), jnp.int32)],
        axis=1)

    # State at diag d-1 and d-2: (M, UG, LG, Ml, Ul, Ll, Mi, Ui, Li)
    def init_diag(d):
        negf = jnp.broadcast_to(neg, (P, R)).astype(i32)
        zeros = jnp.zeros((P, R), i32)
        dfull = jnp.full((P, R), d, i32)
        if d == 0:
            # only cell (0,0): M=0, UG=LG=neg, all lens/ids 0
            M = jnp.where(rows == 0, 0, negf)
            UG = negf
            LG = negf
            Ml = zeros
        else:
            # d == 1: boundary cells (0,1) [top] and (1,0) [left]:
            #   UG(0,c) = -go - c*gc ; LG(i,0) = -go - i*gc ; M = neg
            M = negf
            UG = jnp.where(rows == 0, -go - d * gc, negf)
            LG = jnp.where(rows == 1, -go - 1 * gc, negf)
            Ml = dfull
        Ul = dfull
        Ll = dfull
        Mi = zeros
        Ui = zeros
        Li = zeros
        return (M, UG, LG, Ml, Ul, Ll, Mi, Ui, Li)

    s_prev2 = init_diag(0)
    s_prev1 = init_diag(1)

    zero_acc = (jnp.zeros((P,), i32), jnp.ones((P,), i32),
                jnp.zeros((P,), i32))

    def step(carry, d):
        s2, s1, acc = carry
        (M2, UG2, LG2, Ml2, Ul2, Ll2, Mi2, Ui2, Li2) = s2
        (M1, UG1, LG1, Ml1, Ul1, Ll1, Mi1, Ui1, Li1) = s1

        # shift-by-one helpers: X1m[i] = X1[i-1]
        def sh(x):
            return jnp.concatenate([jnp.full((P, 1), 0, i32), x[:, :-1]],
                                   axis=1)

        # substitution score for cell (i, d-i)
        bdiag = jax.lax.dynamic_slice(
            brev_pad, (jnp.int32(0), jnp.int32(L2max + R) - d),
            (P, R))                                  # B_d[i] = seq2[d-1-i]
        s_sub = jnp.where(A == bdiag, match, mismatch)

        # UG(i,d) from (i, d-1): same row index i
        ygap_begin = M1 - (go + gc)
        ygap_cont = UG1 - gc
        ug = jnp.maximum(ygap_begin, ygap_cont)
        take_begin = ug == ygap_begin
        ul = jnp.where(take_begin, Ml1 + 1, Ul1 + 1)
        ui = jnp.where(take_begin, Mi1, Ui1)

        # M(i,d) from (i-1, d-2): shift prev2 by one row
        M2s, LG2s, UG2s = sh(M2), sh(LG2), sh(UG2)
        Ml2s, Ll2s, Ul2s = sh(Ml2), sh(Ll2), sh(Ul2)
        Mi2s, Li2s, Ui2s = sh(Mi2), sh(Li2), sh(Ui2)
        matched = M2s + s_sub
        xgap_end = LG2s + s_sub
        ygap_end = UG2s + s_sub
        m = jnp.maximum(jnp.maximum(matched, xgap_end), ygap_end)
        is_matched = m == matched
        is_xgap = (~is_matched) & (m == xgap_end)
        inc = (s_sub == match).astype(i32)
        ml = jnp.where(is_matched, Ml2s + 1,
                       jnp.where(is_xgap, Ll2s + 1, Ul2s + 1))
        mi = jnp.where(is_matched, Mi2s + inc,
                       jnp.where(is_xgap, Li2s + inc, Ui2s + inc))

        # LG(i,d) from (i-1, d-1): shift prev1 by one row
        M1s, LG1s = sh(M1), sh(LG1)
        Ml1s, Ll1s = sh(Ml1), sh(Ll1)
        Mi1s, Li1s = sh(Mi1), sh(Li1)
        xgap_begin = M1s - (go + gc)
        xgap_cont = LG1s - gc
        lg = jnp.maximum(xgap_begin, xgap_cont)
        take_beg = lg == xgap_begin
        ll = jnp.where(take_beg, Ml1s + 1, Ll1s + 1)
        li = jnp.where(take_beg, Mi1s, Li1s)

        # overwrite boundaries: i == 0 (j = d) and i == d (j = 0)
        at_top = rows == 0
        at_left = rows == d
        m = jnp.where(at_top | at_left, neg, m)
        ml = jnp.where(at_top | at_left, d, ml)
        mi = jnp.where(at_top | at_left, 0, mi)
        ug = jnp.where(at_top, -go - d * gc, jnp.where(at_left, neg, ug))
        ul = jnp.where(at_top | at_left, d, ul)
        ui = jnp.where(at_top | at_left, 0, ui)
        lg = jnp.where(at_left, -go - d * gc, jnp.where(at_top, neg, lg))
        ll = jnp.where(at_top | at_left, d, ll)
        li = jnp.where(at_top | at_left, 0, li)

        new1 = (m, ug, lg, ml, ul, ll, mi, ui, li)

        # readout when d == l1 + l2, at row i = l1
        done = d == (l1 + l2)
        idx = jnp.clip(l1, 0, R - 1)[:, None]

        def pick(x):
            return jnp.take_along_axis(x, idx, axis=1)[:, 0]

        fm, flg, fug = pick(m), pick(lg), pick(ug)
        score = jnp.maximum(jnp.maximum(fm, flg), fug)
        from_m = score == fm
        from_lg = (~from_m) & (score == flg)
        alen = jnp.where(from_m, pick(ml),
                         jnp.where(from_lg, pick(ll), pick(ul)))
        amatch = jnp.where(from_m, pick(mi),
                           jnp.where(from_lg, pick(li), pick(ui)))
        acc_score, acc_len, acc_match = acc
        acc = (jnp.where(done, score, acc_score),
               jnp.where(done, alen, acc_len),
               jnp.where(done, amatch, acc_match))
        return (s1, new1, acc), None

    (s_prev2, s_prev1, acc), _ = jax.lax.scan(
        step, (s_prev2, s_prev1, zero_acc), jnp.arange(2, D, dtype=i32))

    # pairs with l1 + l2 < 2 (degenerate) keep acc defaults.
    # identity = matches/length is re-derived in float64 on host by callers
    # (ref getIdentity does the division in double, GlobAlignE.cpp:301-305);
    # the on-device value is a convenience (f32 unless x64 is enabled).
    score, alen, amatch = acc
    identity = amatch / jnp.maximum(alen, 1).astype(jnp.float32)
    return score, alen, amatch, identity


# ---------------------------------------------------------------------------
# Host-side batching helpers
# ---------------------------------------------------------------------------

def align_identity_batch(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                         match: int = 1, mismatch: int = -1, go: int = 2,
                         gc: int = 1, max_batch: int = 512) -> np.ndarray:
    """Identities for a list of (codes_a, codes_b) uint8 pairs.

    Buckets pairs by padded lengths to bound recompiles; the longer sequence
    is placed on the row axis (alignment is symmetric in score; the reference
    always calls with (a=first, b=second) — we preserve operand order).
    """
    n = len(pairs)
    out = np.zeros(n, np.float64)
    if n == 0:
        return out

    def bucket_len(x: int, fine: bool = False) -> int:
        """Padded length bucket. fine=True uses quarter-octave steps
        (<=25% pad waste) — worth it on the DP row axis where padding costs
        compute every diagonal; coarse (power-of-2) elsewhere."""
        if x <= 64:
            return 64
        if not fine:
            b = 64
            while b < x:
                b *= 2
            return b
        step = max(64, (1 << (int(x - 1).bit_length() - 1)) // 4)
        return ((x + step - 1) // step) * step

    groups = {}
    for idx, (a, b) in enumerate(pairs):
        key = (bucket_len(len(a)), bucket_len(len(b)))
        groups.setdefault(key, []).append(idx)

    for (ba, bb), idxs in groups.items():
        for s in range(0, len(idxs), max_batch):
            chunk = idxs[s: s + max_batch]
            # fixed batch-dim bucket: ONE (P, R, D) scan program per length
            # bucket across probe rounds, labeling, and warmup
            P = max_batch
            s1 = np.zeros((P, ba), np.uint8)
            s2 = np.zeros((P, bb), np.uint8)
            l1 = np.ones(P, np.int32)
            l2 = np.ones(P, np.int32)
            for r, idx in enumerate(chunk):
                a, b = pairs[idx]
                s1[r, : len(a)] = a
                s2[r, : len(b)] = b
                l1[r] = len(a)
                l2[r] = len(b)
            R = ba + 1
            D = ba + bb + 1
            _, alen, amatch, _ = batch_align(
                jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(l1),
                jnp.asarray(l2), R=R, D=D, match=match, mismatch=mismatch,
                go=go, gc=gc)
            ident = (np.asarray(amatch, np.float64)
                     / np.maximum(np.asarray(alen, np.float64), 1.0))
            out[np.asarray(chunk)] = ident[: len(chunk)]
    return out
