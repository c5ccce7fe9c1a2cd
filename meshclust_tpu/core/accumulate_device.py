"""Device-resident mean-shift accumulation (phase A) — the flagship kernel.

The reference's accumulate (ClusterFactory.cpp:637-714) is a sequential loop:
classify a length-window of live candidates against the current center,
absorb the positives, move the center to the member closest to the member
mean, repeat until stable, then seed the next center from the most-similar
remaining candidate. The host-driven version pays a device round-trip per
iteration; this module runs the ENTIRE phase in one jitted call using
`lax.while_loop`s, with all state device-resident:

  slots: the finalized bvec order (bins concatenated; globally non-decreasing
  length). Static per-slot arrays: point row, length, bin id. Dynamic: active
  mask, owner (center id per absorbed slot), stamp (absorb order).

Window bounds reproduce bvec::get_range semantics exactly (SURVEY C7):
  - index_of: linear-scan rule over begin_bounds (bvec.cpp:122-149),
  - inner_index_of: for live sorted in-bin lengths L and query x —
      front = x < L[0] ? 0 : min(lower_bound(L, x), size-1)
      back  = x > L[-1] ? size-1 : (found ? upper_bound(L, x)-1
                                          : min(lower_bound(L, x), size-1))
    (closed forms of the reference's binary-search walk; verified against
    the host emulation in tests/test_accum_device.py),
  - empty-bin fallbacks: front -> first live slot of first non-empty bin,
    back -> FIRST live slot of the last non-empty bin (the truncation quirk).

Work scales with LIVE candidates, not N (the round-1 version classified all
N slots every inner iteration — O(N^2 V) over a run): each inner iteration
sweeps the live slots inside the window in fixed [TILE] chunks, gathering
rows by live-rank (searchsorted over the active prefix sum), exactly like
the reference only ever touches the live points the bvec still holds. The
member-mean argmin (get_mean, ClusterFactory.cpp:382-425) likewise sweeps an
incrementally-maintained member list instead of masking all N rows. Per-run
HBM traffic drops from (#iterations x N x V) to (#iterations x window_live
x V) — the same asymptotics as the reference, at vector width.

Classifier math matches core/classify.DeviceBackend (f32); distance_d keeps
the reference's per-element truncation. All reductions take the FIRST
occurrence on ties (slot order == the reference's iteration order; members
in (stamp, slot) order == the reference's member-list order).
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from meshclust_tpu.ops import features as F

INF = jnp.float32(np.inf)


def exact_mode(use_ds: bool) -> str:
    """Resolve the arithmetic mode for classifier decisions.

    'cert' (default when inputs are f32-exact): certified f32 with a DS
    fallback cond — decisions bit-identical to 'ds' at ~f32 cost
    (ops/certify.py). 'ds': always double-single (the round-3/4 path;
    MESHCLUST_EXACT_MODE=ds forces it, for A/B). 'f32': plain f32
    (inputs not exact, documented drift)."""
    import os
    forced = os.environ.get("MESHCLUST_EXACT_MODE", "")
    if forced in ("ds", "f32", "cert"):
        return forced
    return "cert" if use_ds else "f32"


def _pick_tile(N: int) -> int:
    """Static sweep-chunk width: one tile for small runs, a bounded
    working set ([TILE, V] f32 gather) for large ones. Override with
    MESHCLUST_ACCUM_TILE."""
    import os
    t_env = int(os.environ.get("MESHCLUST_ACCUM_TILE", "0"))
    if t_env:
        return t_env
    t = 512
    while t < N and t < 4096:
        t *= 2
    return t


_BUILD_CACHE: dict = {}


def build_accumulate(N: int, V: int, nbins: int, Cmax: int, sim: float,
                     singles, combos, tile: int = 0, mode: str = "f32",
                     mesh=None):
    """Build the jitted full-phase-A function.

    Static: N slots, V lanes, nbins, Cmax center capacity, similarity, the
    combo structure. Inputs are the per-slot arrays; returns (owner [N],
    stamp [N], center_slot [Cmax], n_centers). Built programs are cached
    process-wide so repeat runs skip the (large) retrace.

    mode: 'ds' = every classifier score / distance_d / f1 comparison in
    double-single (ops/ds.py) — decisions equal the float64 host oracle.
    'cert' = certified f32 (ops/certify.py): same decisions as 'ds', DS
    evaluated only under a lax.cond when a margin is inside the error
    bound (fallback counts returned in nfb). 'f32' = plain f32.

    mesh: a 1-D jax Mesh to shard the FEATURE axis over (round-4 verdict
    #1b: the dominant phase must use the mesh). Every V-reduction in the
    program (man, dot, dist, mag, sum(cw)) sums exact integer-valued f32
    (< 2^24, gated by ds_inputs_exact / the nfb[3] telemetry), so psum of
    per-shard exact partials is order-independent and the sharded program
    is BIT-IDENTICAL to the replicated one; the DS/cert tie-break machinery
    consumes only those already-reduced scalars (ops/ds_classify.py). Per-
    device HBM traffic for the [N, V] sweeps, which bound the phase, drops
    by the mesh size."""
    singles = tuple(singles)
    combos = tuple((c, tuple(ix)) for c, ix in combos)
    T = tile or _pick_tile(N)
    import os as _os
    # compile-time ablation knobs for perf probing ONLY (wrong results):
    # tokens: nowin (full-range window), noargmin (center never moves),
    # nobest (skip seed selection)
    dbg = frozenset(
        t for t in _os.environ.get("MESHCLUST_ACCUM_DBG", "").split(",")
        if t)
    ax = mesh.axis_names[0] if mesh is not None else None
    mesh_key = ((ax, tuple(int(d.id) for d in mesh.devices.flat))
                if mesh is not None else None)
    key = (N, V, nbins, Cmax, float(sim), singles, combos, T, mode, dbg,
           mesh_key)
    cached = _BUILD_CACHE.get(key)
    if cached is not None:
        return cached
    use_ds = mode == "ds"

    def _vsum(x):
        """Exact cross-shard reduction of integer-valued f32 partials."""
        return jax.lax.psum(x, ax) if ax else x

    def _vmax(x):
        return jax.lax.pmax(x, ax) if ax else x

    def fn(hist_s, mag_s, sq_s, len_s, orig_ids, bin_of, bin_start,
           bin_end, begin_bounds, mins, maxs, is_sim, weights,
           active, owner, stamp, t0, seed0, c0, center_slot, done0,
           nfb0, c_limit):
        """One bounded dispatch: continue the accumulation from the given
        state until done OR c reaches c_limit. Bounding the per-dispatch
        center count keeps single-program runtime under a runtime
        watchdog (an unbounded 1M-point program can run for minutes in
        one dispatch) and lets the host report progress between chunks.
        State arrays are donated.

        Slots are BUCKET-LOCAL: the driver periodically compacts the live
        set into a smaller power-of-4 bucket (absorbed members are never
        accessed after their center completes), rebuilding per-bucket
        consts. orig_ids maps bucket slots back to original slots; only
        center_slot records original ids (owner/stamp are bucket-local and
        flushed by the driver at compaction)."""
        i32 = jnp.int32
        len_i = len_s.astype(i32)
        t_ar = jnp.arange(T, dtype=i32)

        def index_of(length):
            """bvec::index_of (low, high) over begin_bounds."""
            bb = begin_bounds
            prev = jnp.concatenate([jnp.zeros(1, i32), bb[:-1]])
            prev_index = jnp.maximum(
                jnp.arange(nbins, dtype=i32) - 1, 0)
            cond = (length >= prev) & (length <= bb)
            low = jnp.min(jnp.where(cond, prev_index, nbins - 1))
            high = jnp.max(jnp.where(cond, prev_index, 0))
            high = jnp.where(length >= bb[nbins - 1],
                             jnp.maximum(high, nbins - 1), high)
            return low.astype(i32), high.astype(i32)

        def window_bounds(length, active):
            """Absolute inclusive slot range [w0, w1] of get_range(
            length*sim, length/sim) on the live structure — pure masked
            min/max reductions (the round-4 version maintained a live-rank
            cumsum + binary searches per iteration, ~25% of the absorb
            iteration wall; lengths are globally sorted over slots so every
            bvec::inner_index_of case collapses to a first/last live slot
            under a mask; semantics cross-checked against the host bvec
            emulation by tests/test_accum_device.py and the golden table).

            Cases (bvec.cpp:52-120,246-278):
              front: first live slot of the front bin with len >= lo;
                     none -> LAST live slot of that bin; empty bin ->
                     first live slot overall (first non-empty bin).
              back:  last live slot of the back bin with len == hi; else
                     first live slot with len > hi; else last live slot;
                     empty bin -> FIRST live slot of the LAST non-empty
                     bin (the truncation quirk)."""
            lo = jnp.floor(
                length.astype(jnp.float32) * jnp.float32(sim)).astype(i32)
            hi = jnp.floor(
                length.astype(jnp.float32) / jnp.float32(sim)).astype(i32)
            fbin = index_of(lo)[0]
            bbin = index_of(hi)[1]

            act_min = jnp.where(active, slots_i, N)
            act_max = jnp.where(active, slots_i, -1)
            glob_first = jnp.min(act_min)
            glob_last = jnp.max(act_max)
            any_live = glob_last >= 0

            bf = active & (bin_of == fbin)
            s_ge = jnp.min(jnp.where(bf & (len_i >= lo), slots_i, N))
            s_last_f = jnp.max(jnp.where(bf, slots_i, -1))
            w0_main = jnp.where(s_ge < N, s_ge, s_last_f)
            w0 = jnp.where(s_last_f >= 0, w0_main,
                           jnp.where(any_live, glob_first, i32(N)))

            bb_ = active & (bin_of == bbin)
            s_eq_last = jnp.max(jnp.where(bb_ & (len_i == hi),
                                          slots_i, -1))
            s_gt = jnp.min(jnp.where(bb_ & (len_i > hi), slots_i, N))
            s_last_b = jnp.max(jnp.where(bb_, slots_i, -1))
            w1_main = jnp.where(
                s_eq_last >= 0, s_eq_last,
                jnp.where(s_gt < N, s_gt, s_last_b))
            b_star = bin_of[jnp.clip(glob_last, 0, N - 1)]
            first_of_last = jnp.min(jnp.where(
                active & (bin_of == b_star), slots_i, N))
            w1 = jnp.where(s_last_b >= 0, w1_main,
                           jnp.where(any_live, first_of_last, i32(-1)))
            return w0, w1

        slots_f = jnp.arange(N, dtype=jnp.float32)
        slots_i = jnp.arange(N, dtype=i32)

        def _ds_score_full(man, dot, mg_c, sq_c, ln_c):
            """Full-[N] DS evaluation from precomputed man/dot (the cert
            fallback and the 'ds' mode share it)."""
            from meshclust_tpu.ops import ds_classify as DSC
            return DSC.score(singles, combos, mins, maxs, is_sim, weights,
                             man, dot, mag_s, mg_c, sq_s, sq_c,
                             len_s, ln_c, V)

        def classify_full(w0, w1, last_slot, owner, stamp, active,
                          sumvec, count, t, c, nfb):
            """Full-array masked sweep: classify EVERY slot against the
            center at last_slot in a handful of fused [N, V]/[N] ops, mask
            to live in-window rows, absorb positives. Replaces a rank-tile
            while_loop whose per-tile dispatch overhead (~25 ops per tile)
            dominated the absorb iteration; one full-N pass trades touching
            every row for a handful of fused ops.
            All row reductions are exact (integer-valued f32 < 2^24), so
            results are bit-identical to the tiled path.

            In 'cert' mode the score runs in certified f32; the DS
            evaluation only fires (lax.cond) when some window row's margin
            is inside the certified bound, and the first-max f1 `best` is
            certified ONLY on the is_min iteration — the sole one whose
            value the outer loop consumes (ClusterFactory.cpp:686-693)."""
            h_c = hist_s[last_slot].astype(jnp.float32)
            mg_c = mag_s[last_slot]
            sq_c = sq_s[last_slot]
            ln_c = len_s[last_slot]
            ok = active & (slots_i >= w0) & (slots_i <= w1) \
                & (w1 >= w0)
            h_f = hist_s.astype(jnp.float32)
            # man/dot are the ONLY V-reductions of the classifier; exact
            # integer f32 sums, so the cross-shard psum is bit-exact and
            # everything downstream (cert bounds, DS fallbacks) consumes
            # replicated scalars.
            man = _vsum(jnp.sum(jnp.abs(h_f - h_c[None, :]), axis=1))
            dot = _vsum(jnp.dot(h_f, h_c, precision=F.HIGHEST))
            if mode == "cert":
                from meshclust_tpu.ops import certify as CT
                s, eps_s, f1, eps_f1 = CT.score(
                    singles, combos, mins[0], maxs[0], is_sim, weights[0],
                    man, dot, mag_s, mg_c, sq_s, sq_c, len_s, ln_c, V)
                unc_s = jnp.any(ok & (jnp.abs(s) <= eps_s))
                pos = jax.lax.cond(
                    unc_s,
                    lambda _: _ds_score_full(man, dot, mg_c, sq_c, ln_c)[0],
                    lambda _: s >= 0.0, None)
                nfb = nfb.at[0].add(unc_s.astype(i32))
            elif use_ds:
                from meshclust_tpu.ops import ds_classify as DSC
                pos, f1h, f1l = DSC.score(
                    singles, combos, mins, maxs, is_sim, weights, man, dot,
                    mag_s, mg_c, sq_s, sq_c, len_s, ln_c, V)
            else:
                from meshclust_tpu.core.classify import _score_rows_f32
                pos, f1h = _score_rows_f32(
                    singles, combos, V, man, dot, mag_s, mg_c, sq_s, sq_c,
                    len_s, ln_c, mins, maxs, is_sim, weights)
                f1l = jnp.zeros_like(f1h)
            pos = pos & ok
            any_ok = jnp.any(ok)
            if mode != "cert":
                # first-max f1 over the window, slot order (strict >)
                f1hm = jnp.where(ok, f1h, -INF)
                bh = jnp.max(f1hm)
                cand = (f1hm == bh) & ok
                blm = jnp.where(cand, f1l, -INF)
                bl = jnp.max(blm)
                best = jnp.where(
                    any_ok,
                    jnp.argmax(cand & (blm == bl)).astype(i32), i32(-1))
            # absorb positives
            owner = jnp.where(pos, c, owner)
            stamp = jnp.where(pos, t, stamp)
            active = active & ~pos
            npos_i = jnp.sum(pos, dtype=i32)
            # [1,N]x[N,V] matvec: exact integer f32 accumulation. NOT
            # wrapped in lax.cond: a cond branch capturing h_f forces the
            # u8->f32 convert to materialize as a 1 GB branch operand at
            # 1M x 256; unconditional, the convert fuses into the dot.
            sumvec = sumvec + jax.lax.dot_general(
                pos.astype(jnp.float32)[None, :], h_f,
                (((1,), (0,)), ((), ())), precision=F.HIGHEST,
                preferred_element_type=jnp.float32)[0]
            count = count + npos_i.astype(jnp.float32)
            # exactness telemetry: per-lane cluster sums must stay < 2^24
            # for the integer-f32 accumulation (and the DS/cert mean) to
            # be exact; the driver warns if this ever trips (ADVICE r4).
            nfb = nfb.at[3].max(_vmax(jnp.max(sumvec)).astype(i32))
            any_pos = npos_i > 0
            if mode == "cert":
                def certified_best(nfb):
                    f1m = jnp.where(ok, f1, -INF)
                    bh = jnp.max(f1m)
                    win = jnp.argmax(f1m).astype(i32)   # first max
                    epsm = jnp.max(jnp.where(ok, eps_f1, 0.0))
                    near = ok & (f1m >= bh - (eps_f1 + epsm))
                    # rows with inputs identical to the winner's give a
                    # bitwise-equal f1 in f32 AND f64 — first-index wins
                    # either way; only DISTINCT-input near rows need DS
                    wc = jnp.clip(win, 0, N - 1)
                    dw = ((man != man[wc]) | (dot != dot[wc])
                          | (mag_s != mag_s[wc]) | (sq_s != sq_s[wc])
                          | (len_s != len_s[wc]))
                    unc_b = jnp.any(near & dw)

                    def ds_best(_):
                        _, f1h2, f1l2 = _ds_score_full(man, dot, mg_c,
                                                       sq_c, ln_c)
                        f1hm = jnp.where(ok, f1h2, -INF)
                        bh2 = jnp.max(f1hm)
                        cnd = (f1hm == bh2) & ok
                        blm = jnp.where(cnd, f1l2, -INF)
                        bl2 = jnp.max(blm)
                        return jnp.argmax(cnd & (blm == bl2)).astype(i32)

                    best = jax.lax.cond(unc_b, ds_best,
                                        lambda _: win, None)
                    return (jnp.where(any_ok, best, i32(-1)),
                            nfb.at[1].add(unc_b.astype(i32)))

                # only the is_min iteration's best is consumed
                if "nobest" in dbg:
                    best = i32(-1)
                else:
                    best, nfb = jax.lax.cond(
                        any_pos, lambda nfb: (i32(-1), nfb),
                        certified_best, nfb)
            return (owner, stamp, active, sumvec, count, best, any_pos,
                    nfb)

        IMAX = jnp.int32(np.iinfo(np.int32).max)

        def _lex_tail(cand, stamp):
            """First member in insertion order among cand == lexicographic
            (stamp, slot) min — int32 throughout (a float32 stamp cast
            collapses distinct stamps past 2^24 cumulative iterations)."""
            ms = jnp.min(jnp.where(cand, stamp, IMAX))
            cand = cand & (stamp == ms)
            return jnp.min(jnp.where(cand, slots_i, i32(N))).astype(i32)

        def _ds_argmin(mask, stamp, sumvec, count):
            from meshclust_tpu.ops import ds_classify as DSC
            h_f = hist_s.astype(jnp.float32)
            cw = DSC.cw_exact(sumvec, count)
            # dist/mag are exact integer f32 sums over V (the only V-
            # reductions): psum the per-shard partials, then the DS frac/d
            # arithmetic runs on replicated scalars
            dist = 2.0 * _vsum(jnp.sum(
                jnp.minimum(h_f, jnp.broadcast_to(cw, h_f.shape)), axis=-1))
            mg = _vsum(jnp.sum(h_f, axis=-1) + jnp.sum(cw))
            dh, dl = DSC.distance_d_scalars(dist, mg)
            dh = jnp.where(mask, dh, INF)
            dl = jnp.where(mask, dl, INF)
            mh = jnp.min(dh)
            cand = (dh == mh) & mask
            ml = jnp.min(jnp.where(cand, dl, INF))
            return _lex_tail(cand & (dl == ml), stamp)

        def mean_argmin_full(owner, stamp, c, sumvec, count, nfb):
            """get_mean: member argmin of distance_d over owner == c.
            First min in member-insertion order == lexicographic
            (dh, dl, stamp, slot) min, since members were appended in
            (stamp, slot) order.

            'cert' mode: cw = floor(mean) is computed EXACTLY by integer
            division (for integer sums/counts < 2^24 the f64 quotient
            never rounds across an integer, so this equals the
            reference's double mean + truncation); d then depends only on
            the exact int pair (dist, mg), so near-min rows are uncertain
            only when their (dist, mg) differs from the winner's — exact
            duplicates never trigger the DS fallback."""
            mask = owner == c
            h_f = hist_s.astype(jnp.float32)
            if mode == "ds":
                return _ds_argmin(mask, stamp, sumvec, count), nfb
            if mode == "cert":
                from meshclust_tpu.ops import certify as CT
                cnt_i = jnp.maximum(count, 1.0).astype(i32)
                cw_i = CT.exact_floor_div(
                    sumvec.astype(i32),
                    jnp.broadcast_to(cnt_i, sumvec.shape))
                cw = cw_i.astype(jnp.float32)
            else:
                mean = sumvec / jnp.maximum(count, 1.0)
                cw = jnp.floor(mean)
            dist = 2.0 * _vsum(
                jnp.sum(jnp.minimum(h_f, cw[None, :]), axis=1))
            # exact identity for integer h: floor(h + mean) = h +
            # floor(mean) (both < 2^24, the f32 add is exact), so the
            # [N, V] floor pass collapses to mag + sum(floor(mean))
            mg = mag_s + _vsum(jnp.sum(cw))
            if mode == "cert":
                d, eps_d = CT.distance_d(dist, mg)
            else:
                frac = dist / jnp.maximum(mg, 1.0)
                d = 10000.0 * (1.0 - frac * frac)
            dm = jnp.where(mask, d, INF)
            mh = jnp.min(dm)
            bs = _lex_tail((dm == mh) & mask, stamp)
            if mode != "cert":
                return bs, nfb
            epsm = jnp.max(jnp.where(mask, eps_d, 0.0))
            near = mask & (dm <= mh + eps_d + epsm)
            bc = jnp.clip(bs, 0, N - 1)
            unc = jnp.any(near & ((dist != dist[bc]) | (mg != mg[bc])))
            out = jax.lax.cond(
                unc, lambda _: _ds_argmin(mask, stamp, sumvec, count),
                lambda _: bs, None)
            return out, nfb.at[2].add(unc.astype(i32))

        def inner_body(state):
            (active, owner, stamp, t, last_slot, c, sumvec, count,
             is_min, _prev_best, nfb) = state
            if "nowin" in dbg:
                w0, w1 = i32(0), i32(N - 1)
            else:
                length = len_i[last_slot]
                w0, w1 = window_bounds(length, active)
            (owner, stamp, active, sumvec, count, best,
             any_pos, nfb) = classify_full(
                w0, w1, last_slot, owner, stamp, active, sumvec, count,
                t, c, nfb)

            if "noargmin" not in dbg:
                last_slot, nfb = jax.lax.cond(
                    any_pos,
                    lambda nfb: mean_argmin_full(owner, stamp, c, sumvec,
                                                 count, nfb),
                    lambda nfb: (last_slot, nfb), nfb)

            return (active, owner, stamp, t + 1, last_slot, c, sumvec,
                    count, ~any_pos, best, nfb)

        def inner_cond(state):
            return ~state[8]

        def outer_body(state):
            (active, owner, stamp, t, seed_slot, c, center_slot, done,
             nfb) = state
            # start a center at seed_slot
            owner = owner.at[seed_slot].set(c)
            stamp = stamp.at[seed_slot].set(t)
            sumvec = hist_s[seed_slot].astype(jnp.float32)
            count = jnp.float32(1.0)
            inner_state = (active, owner, stamp, t + 1, seed_slot, c,
                           sumvec, count, jnp.bool_(False), i32(-1), nfb)
            (active, owner, stamp, t, last_slot, _, _, _, _,
             best, nfb) = jax.lax.while_loop(inner_cond, inner_body,
                                             inner_state)
            center_slot = center_slot.at[c].set(orig_ids[last_slot])

            # next seed: best candidate (erase) or pop() (first live slot)
            def from_best(_):
                return best, active.at[best].set(False)

            def from_pop(_):
                s = jnp.min(jnp.where(active, slots_i, i32(N)))
                return s, active.at[s].set(False, mode="drop")

            next_seed, active = jax.lax.cond(best >= 0, from_best,
                                             from_pop, None)
            done = (next_seed >= N) | (next_seed < 0) | (c + 1 >= Cmax)
            next_seed = jnp.clip(next_seed, 0, N - 1)
            return (active, owner, stamp, t, next_seed, c + 1,
                    center_slot, done, nfb)

        def outer_cond(state):
            return ~state[7] & (state[5] < c_limit)

        state = (active, owner, stamp, t0, seed0, c0, center_slot, done0,
                 nfb0)
        return jax.lax.while_loop(outer_cond, outer_body, state)

    if mesh is None:
        jitted = jax.jit(fn, donate_argnums=(13, 14, 15, 19, 21))
    else:
        from jax.sharding import PartitionSpec as P
        try:
            from jax import shard_map            # JAX >= 0.8
        except ImportError:
            from jax.experimental.shard_map import shard_map
        pv, pr = P(None, ax), P()
        # arg 0 (hist_s [N, V]) sharded on the feature axis; all slot-/
        # center-/scalar-state replicated (identical on every device by
        # construction: the only cross-device values are psum'd exact ints)
        kw = {}
        import inspect
        sig = inspect.signature(shard_map).parameters
        if "check_rep" in sig:
            kw["check_rep"] = False
        elif "check_vma" in sig:
            kw["check_vma"] = False
        sm = shard_map(fn, mesh=mesh, in_specs=(pv,) + (pr,) * 22,
                       out_specs=(pr,) * 9, **kw)
        jitted = jax.jit(sm)
    _BUILD_CACHE[key] = jitted
    return jitted


def accumulate_device(ps, bv, params: F.FeatureParams, sim: float,
                      cmax_hint: int = 0, mesh=None):
    """Run phase A on device. `bv` must be a finalized BVec; returns the
    Center list in reference semantics (see core/meanshift.Center).

    mesh: optional 1-D Mesh — shards the [N, V] feature streams (the
    phase's HBM roofline) across devices with bit-identical results; see
    build_accumulate. Ignored (replicated) when V does not divide evenly
    or MESHCLUST_PHASEA_SHARD=0."""
    from meshclust_tpu.core.meanshift import Center

    slots_point = np.concatenate([np.asarray(b, np.int64) for b in bv.idx])
    N = slots_point.shape[0]
    nbins = len(bv.idx)
    bin_sizes = [len(b) for b in bv.idx]
    bin_start = np.zeros(nbins, np.int32)
    bin_end = np.zeros(nbins, np.int32)
    off = 0
    bin_of = np.zeros(N, np.int32)
    for b, sz in enumerate(bin_sizes):
        bin_start[b] = off
        bin_end[b] = off + sz
        bin_of[off: off + sz] = b
        off += sz
    begin_bounds = np.asarray(bv.begin_bounds, np.int32)

    dev = ps.device_arrays()
    sp = jnp.asarray(slots_point.astype(np.int32))
    hist_s = dev["hist"][sp]
    mag_s = dev["mag"][sp]
    sq_s = dev["sq"][sp]
    len_s = dev["len"][sp]

    from meshclust_tpu.ops import ds as DS
    from meshclust_tpu.ops import ds_classify as DSC
    use_ds = DS.ds_inputs_exact(int(ps.mag.max()), int(ps.sq.max()))
    mode = exact_mode(use_ds)
    if mode in ("ds", "cert"):
        # 'cert' reads the hi words (row 0) as its f32 constants — the
        # f32 roundings of the f64 values — and the full pairs in the
        # DS fallback branches.
        cb = DSC.const_block(params)
        mins_a = jnp.asarray(cb["mins2"])
        maxs_a = jnp.asarray(cb["spans2"])
        weights_a = jnp.asarray(cb["weights2"])
    else:
        mins_a = jnp.asarray(params.mins, jnp.float32)
        maxs_a = jnp.asarray(params.maxs, jnp.float32)
        weights_a = jnp.asarray(params.weights, jnp.float32)

    Cmax = cmax_hint or (N + 1)
    combos_l = [(c, list(ix)) for c, ix in params.combos]
    # Chunked dispatch: K centers per device call (watchdog-safe at any N);
    # state arrays stay device-resident and are donated between calls.
    # Between chunks the live set is COMPACTED into a smaller power-of-2
    # bucket once it shrinks 4x below the current one: absorbed members are
    # never accessed after their center completes, so the full-array sweeps
    # then scale with the live count, not N. Each bucket size is its own
    # compiled program (~5 variants over a full run, persistent-cached).
    import os
    if mesh is not None and (
            ps.V % mesh.devices.size != 0
            or os.environ.get("MESHCLUST_PHASEA_SHARD", "1") != "1"):
        mesh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ax0 = mesh.axis_names[0]
        hist_s = jax.device_put(hist_s, NamedSharding(mesh, P(None, ax0)))
        repl = NamedSharding(mesh, P())
        mag_s = jax.device_put(mag_s, repl)
        sq_s = jax.device_put(sq_s, repl)
        len_s = jax.device_put(len_s, repl)
    K = max(1, int(os.environ.get("MESHCLUST_ACCUM_CHUNK", "512")))
    compact_on = os.environ.get("MESHCLUST_ACCUM_COMPACT", "1") == "1"
    min_bucket = int(os.environ.get("MESHCLUST_ACCUM_MINBUCKET", "4096"))
    # Below ~260k points the full-bucket sweeps are cheap and each bucket
    # variant costs a cold compile, so compaction defaults off for small
    # corpora (override via env).
    if "MESHCLUST_ACCUM_COMPACT" not in os.environ and N < 262144:
        compact_on = False
    i32 = jnp.int32
    Nb = N
    hist_b, mag_b, sq_b, len_b = hist_s, mag_s, sq_s, len_s
    orig_b = jnp.arange(N, dtype=i32)
    bin_of_b = jnp.asarray(bin_of)
    bin_start_b = jnp.asarray(bin_start)
    bin_end_b = jnp.asarray(bin_end)
    bb_dev = jnp.asarray(begin_bounds)
    is_sim_a = jnp.asarray(params.is_sim)
    active = jnp.ones(N, bool).at[0].set(False)   # pop() the first seed
    owner_l = jnp.full(N, -1, i32)
    stamp_l = jnp.zeros(N, i32)
    center_slot = jnp.full(Cmax, -1, i32)
    t = i32(0)
    seed = i32(0)
    c = i32(0)
    done = jnp.bool_(False)
    g_owner = np.full(N, -1, np.int32)
    g_stamp = np.zeros(N, np.int32)

    def flush(owner_l, stamp_l, orig_b):
        ow = np.asarray(owner_l)
        st = np.asarray(stamp_l)
        oi = np.asarray(orig_b)
        sel = ow >= 0
        g_owner[oi[sel]] = ow[sel]
        g_stamp[oi[sel]] = st[sel]

    from meshclust_tpu.utils.progress import Progress
    prog = Progress(N + 1, "Accumulation")
    n_done_prev = 0
    t_prev = 0
    # [score_fb, best_fb, argmin_fb, max per-lane cluster sum]
    nfb = jnp.zeros(4, i32)
    while True:
        fn = build_accumulate(Nb, ps.V, nbins, Cmax, sim, params.singles,
                              combos_l, mode=mode, mesh=mesh)
        limit = i32(min(int(c) + K, Cmax))
        (active, owner_l, stamp_l, t, seed, c, center_slot, done,
         nfb) = fn(
            hist_b, mag_b, sq_b, len_b, orig_b, bin_of_b, bin_start_b,
            bin_end_b, bb_dev, mins_a, maxs_a, is_sim_a, weights_a,
            active, owner_l, stamp_l, t, seed, c, center_slot, done,
            nfb, limit)
        live = int(jnp.sum(active))
        n_done = N - (live + 1)
        prog += max(0, n_done - n_done_prev)
        n_done_prev = max(n_done_prev, n_done)
        # traffic model: every absorb iteration streams the bucket's u8
        # histogram ~2.7x (classify read + sumvec matvec + argmin on most
        # iterations); perf reports the achieved GB/s
        from meshclust_tpu.utils import perf as _perf
        _perf.add("accum_sweep_bytes",
                  2.7 * float(int(t) - t_prev) * Nb * ps.V)
        t_prev = int(t)
        if bool(done):
            break
        target = max(min_bucket, 1 << (live + 1).bit_length())
        if compact_on and target <= Nb // 2:
            # retain the pending seed slot (inactive but not yet absorbed)
            keep = active.at[seed].set(True)
            perm = jnp.argsort(~keep, stable=True)[:target]
            kept = keep[perm]
            flush(owner_l, stamp_l, orig_b)
            hist_b = hist_b[perm]
            mag_b = mag_b[perm]
            sq_b = sq_b[perm]
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                hist_b = jax.device_put(
                    hist_b, NamedSharding(mesh, P(None, mesh.axis_names[0])))
            # pads sort after every live length in the last bin. 2^30 is
            # f32-exact and converts to int32 safely (len arrays are f32
            # on device; 2^31-1 would round to 2^31 whose i32 convert is
            # implementation-defined), and exceeds any real length (the
            # reference chunks segments at 1 Mbp).
            len_b = jnp.where(kept, len_b[perm],
                              jnp.asarray(2**30, len_b.dtype))
            bin_of_b = jnp.where(kept, bin_of_b[perm], i32(nbins - 1))
            orig_new = jnp.where(kept, orig_b[perm], i32(N))
            rng_b = jnp.arange(nbins, dtype=i32)
            bin_start_b = jnp.searchsorted(bin_of_b, rng_b,
                                           side="left").astype(i32)
            bin_end_b = jnp.searchsorted(bin_of_b, rng_b,
                                         side="right").astype(i32)
            seed = i32(int(jnp.argmax(perm == seed)))
            orig_b = orig_new
            active = kept & active[perm]
            owner_l = jnp.full(target, -1, i32)
            stamp_l = jnp.zeros(target, i32)
            Nb = target
    prog.end()
    flush(owner_l, stamp_l, orig_b)
    owner = g_owner
    stamp = g_stamp
    center_slot = np.asarray(center_slot)
    n_centers = int(c)
    # perf counters: total absorb iterations (stamps) + centers found
    from meshclust_tpu.utils import perf
    perf.add("accum_iters", float(stamp.max()) if N else 0.0)
    perf.add("accum_centers", float(n_centers))
    fb = np.asarray(nfb)
    if mode == "cert":
        perf.add("accum_fb_score", float(fb[0]))
        perf.add("accum_fb_best", float(fb[1]))
        perf.add("accum_fb_argmin", float(fb[2]))
    perf.add("accum_max_lane_sum", float(fb[3]))
    if mode in ("ds", "cert") and int(fb[3]) >= (1 << 24):
        from meshclust_tpu.utils.log import log
        log(f"WARNING: a cluster's per-lane histogram sum reached "
            f"{int(fb[3])} >= 2^24; mean-histogram arithmetic is no "
            f"longer exactly integer in f32 and center selection may "
            f"drift from the reference's double precision")
    if n_centers > Cmax:
        raise RuntimeError("center capacity exceeded; raise cmax_hint")

    # group members by owner keeping (stamp, slot) insertion order —
    # vectorized (a Python loop over N slots costs seconds at 1M)
    order = np.lexsort((np.arange(N), stamp))   # (stamp, slot) order
    ow = owner[order]
    pts = slots_point[order]
    sel = (ow >= 0) & (ow < n_centers)
    ow = ow[sel]
    pts = pts[sel]
    grp = np.argsort(ow, kind="stable")         # per-owner, order preserved
    ow_s = ow[grp]
    pts_s = pts[grp]
    bounds = np.searchsorted(ow_s, np.arange(n_centers + 1))
    centers: List[Center] = []
    for c in range(n_centers):
        centers.append(Center(
            int(slots_point[center_slot[c]]),
            pts_s[bounds[c]: bounds[c + 1]].tolist()))
    return centers
