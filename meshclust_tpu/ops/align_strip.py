"""Pallas kernel (Triton route) for batched GlobAlignE alignment counts.

Same DP, boundary cells and tie-break priorities as `ops/align.batch_align`
(see that module's docstring; reference GlobAlignE.cpp:123-292), laid out
for a GPU instead of as an anti-diagonal wavefront:

- inter-pair: each lane of a program owns one pair (LANES pairs, one warp),
  so lanes never exchange data;
- a program walks its DP in strips of S rows. Within a strip it sweeps the
  columns left to right and keeps the strip's six carried values per row in
  registers: the match / upper-gap / lower-gap scores and, for each, the
  path length and match count packed as (len << 16) | matches. Only the
  strip's bottom row goes to device memory (one column per step, read back
  by the next strip as its top boundary), so a cell costs 2 * 24 / S bytes
  of traffic instead of the scan's full-state round trip;
- each program derives its own bounds from its lanes' lengths: strips stop
  at the block's longest seq1, columns at its longest seq2, and the readout
  of cell (l1, l2) runs only in the strips and columns where some lane's
  final cell can fall.

The packing needs l1 + l2 <= 32767; callers route longer pairs to the scan.
Pairs with l1 == 0 or l2 == 0 end on a boundary cell and are filled in
closed form by `strip_counts`.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from meshclust_tpu.ops.align import neg_inf_sentinel

LANES = 32          # pairs per program: one warp, one lane per pair
STRIP = 16          # DP rows held in registers per strip
PACK_LIMIT = 32767  # (len << 16) | matches needs l1 + l2 below this
_ONE16 = 1 << 16


def _cell(diag, up, left, a, b, *, match, mismatch, go, gc):
    """One DP cell from its three predecessors, each a 6-tuple
    (M, UG, LG, MLI, ULI, LLI); a/b are the two residue codes."""
    Md, Ud, Ld, Mld, Uld, Lld = diag
    Mu, _, Lu, Mlu, _, Llu = up
    Ml, Ul, _, Mll, Ull, _ = left
    s = jnp.where(a == b, match, mismatch)
    # UG(i,j) from (i, j-1): gap-begin over gap-continue (cpp:175-193)
    yb = Ml - (go + gc)
    ug = jnp.maximum(yb, Ul - gc)
    uli = jnp.where(ug == yb, Mll, Ull) + _ONE16
    # M(i,j) from (i-1, j-1): matched > xgapEnd > ygapEnd (cpp:207-241)
    matched = Md + s
    xend = Ld + s
    yend = Ud + s
    m = jnp.maximum(jnp.maximum(matched, xend), yend)
    is_m = m == matched
    is_x = jnp.logical_and(jnp.logical_not(is_m), m == xend)
    inc = jnp.where(s == match, _ONE16 + 1, _ONE16)
    mli = jnp.where(is_m, Mld, jnp.where(is_x, Lld, Uld)) + inc
    # LG(i,j) from (i-1, j): gap-begin over gap-continue (cpp:258-273)
    xb = Mu - (go + gc)
    lg = jnp.maximum(xb, Lu - gc)
    lli = jnp.where(lg == xb, Mlu, Llu) + _ONE16
    return (m, ug, lg, mli, uli, lli)


def _kernel(l1_ref, l2_ref, a_ref, b_ref, out_ref, bnd_ref, *, S: int,
            match: int, mismatch: int, go: int, gc: int):
    i32 = jnp.int32
    lanes = pl.ds(pl.program_id(0) * LANES, LANES)
    l1 = l1_ref[lanes]
    l2 = l2_ref[lanes]
    neg = neg_inf_sentinel(l1, l2, mismatch, go, gc).astype(i32)
    zero = jnp.zeros_like(l1)
    l1max = jnp.max(l1)
    l2max = jnp.max(l2)
    # strips [first_cap, n_strips) and columns [l2min, l2max] hold every
    # lane's final cell (l1, l2); the sweep outside them skips the readout
    n_strips = lax.div(l1max + (S - 1), i32(S))
    first_cap = lax.div(jnp.maximum(jnp.min(l1), 1) - 1, i32(S))
    l2min = jnp.maximum(jnp.min(l2), 1)
    cell = functools.partial(_cell, match=match, mismatch=mismatch, go=go,
                             gc=gc)

    def left_edge(i):
        """Column-0 boundary cell (i, 0), i >= 1: only LG is finite."""
        li = zero + (i << 16)
        return (neg, neg, zero + (-go - i * gc), li, li, li)

    def strip(s, acc):
        i0 = 1 + s * S                        # first DP row of the strip
        A = [a_ref[i0 - 1 + r, lanes].astype(i32) for r in range(S)]
        state = [left_edge(i0 + r) for r in range(S)]
        # diagonal predecessor of (i0, 1): the origin (0, 0) or (i0-1, 0)
        origin = (zero, neg, neg, zero, zero, zero)
        tprev = tuple(jnp.where(s == 0, o, e)
                      for o, e in zip(origin, left_edge(i0 - 1)))

        def col(j, carry, capture):
            state, tprev, acc = carry
            # top boundary (i0-1, j): row 0 in closed form for the first
            # strip, else the previous strip's bottom row
            lj = zero + (j << 16)
            row0 = (neg, zero + (-go - j * gc), neg, lj, lj, lj)
            top = tuple(jnp.where(s == 0, r0, bnd_ref[q, j, lanes])
                        for q, r0 in enumerate(row0))
            b = b_ref[j - 1, lanes].astype(i32)
            new = []
            diag, up = tprev, top
            for r in range(S):
                c = cell(diag, up, state[r], A[r], b)
                new.append(c)
                diag, up = state[r], c
            for q in range(6):
                bnd_ref[q, j, lanes] = new[-1][q]
            if capture:
                at = jnp.where(l2 == j, l1 - i0, -1)
                for r in range(S):
                    hit = at == r
                    acc = tuple(jnp.where(hit, v, a)
                                for v, a in zip(new[r], acc))
            return new, top, acc

        cap_lo = jnp.where(s >= first_cap, l2min, l2max + 1)
        carry = (state, tprev, acc)
        carry = lax.fori_loop(1, cap_lo,
                              functools.partial(col, capture=False), carry)
        carry = lax.fori_loop(cap_lo, l2max + 1,
                              functools.partial(col, capture=True), carry)
        return carry[2]

    acc = lax.fori_loop(0, n_strips, strip, (zero,) * 6)
    fm, fu, fl, fml, ful, fll = acc
    # final lane priority: matches > lowerGap > upperGap (cpp:278-291)
    score = jnp.maximum(jnp.maximum(fm, fl), fu)
    from_m = score == fm
    from_lg = jnp.logical_and(jnp.logical_not(from_m), score == fl)
    li = jnp.where(from_m, fml, jnp.where(from_lg, fll, ful))
    out_ref[0, lanes] = score
    out_ref[1, lanes] = li >> 16
    out_ref[2, lanes] = li & 0xFFFF


@functools.partial(jax.jit, static_argnames=(
    "S", "match", "mismatch", "go", "gc", "interpret"))
def strip_counts(a, b, l1, l2, *, S: int = STRIP, match: int = 1,
                 mismatch: int = -1, go: int = 2, gc: int = 1,
                 interpret: bool = False):
    """(alen, amatch) int32 [P] for P pairs.

    a [P, La] seq1 codes with La a multiple of S and >= every l1; b [P, Lb]
    seq2 codes with Lb >= every l2; l1/l2 [P] int32 true lengths; P a
    multiple of LANES. The lanes of one program should have similar
    lengths: the program sweeps its longest pair's full rectangle."""
    P, La = a.shape
    Lb = b.shape[1]
    assert P % LANES == 0 and La % S == 0, (P, La, S)
    i32 = jnp.int32
    l1 = l1.astype(i32)
    l2 = l2.astype(i32)
    kern = functools.partial(_kernel, S=S, match=match, mismatch=mismatch,
                             go=go, gc=gc)
    out, _ = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((3, P), i32),
                   # strip boundary: bottom row of the last strip, per column
                   jax.ShapeDtypeStruct((6, Lb + 1, P), i32)),
        grid=(P // LANES,),
        backend="triton",
        # one warp per program; no software pipelining, so each lane's
        # boundary store is read back in program order by the next strip
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="nw_strip",
    )(l1, l2, a.T.astype(i32), b.T.astype(i32))
    # boundary-cell pairs: the scan's readout there is len = l1 + l2 (or
    # its default 1 for l1 + l2 < 2) with no matches
    edge = (l1 == 0) | (l2 == 0)
    alen = jnp.where(edge, jnp.maximum(l1 + l2, 1), out[1])
    amatch = jnp.where(edge, 0, out[2])
    return alen, amatch
