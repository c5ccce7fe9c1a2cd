"""Multi-chip data parallelism for the mean-shift update phase.

Design (SURVEY §2.4 / §5.8): sequences (cluster members) are sharded along a
1-D 'data' mesh axis; cluster centers are replicated. One update step:

  1. every shard classifies its members against the 2*delta+1 candidate
     centers around each member's current assignment (banded structure),
  2. partial (sum of member histograms, counts) per center -> psum over ICI,
  3. replicated mean per center,
  4. per-shard (distance_d, global-id) argmin of classifier-positive members
     to each center's mean -> lexicographic min-reduction across shards, so
     multi-host output equals single-host output (deterministic global-id
     tie-break).

The classifier math matches core/classify.DeviceBackend (f32). This module
is the scaling skeleton: it is exercised by __graft_entry__.dryrun_multichip
on a virtual CPU mesh and used for N-chip runs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from meshclust_tpu.ops import features as F


class ClassifierParams(NamedTuple):
    mins: jnp.ndarray       # [S] f32
    maxs: jnp.ndarray       # [S]
    is_sim: jnp.ndarray     # [S] bool
    weights: jnp.ndarray    # [1+C] f32


def default_combo_structure():
    """Static combo structure of the default 4-feature model
    (Trainer.cpp:583-588): singles order = [INTERSECTION? ...] — we use the
    canonical lookup order LD, MANHATTAN, INTERSECTION, PEARSON, KULCZYNSKI2
    produced by adding the default menu."""
    f = F.Feature(V=1)
    for flags, combo in F.DEFAULT_FEATURE_MENU:
        f.add_feature(flags, combo)
    return tuple(f.lookup), tuple((c, tuple(ix)) for c, ix in f.combos)


def _classify_cols(h_m, h_c, mag_m, mag_c, sq_m, sq_c, len_m, len_c, V,
                   singles, combos, prm: ClassifierParams):
    """Vectorized classifier for member-vs-center row pairs ([M, V] each).
    Returns (positive bool [M], f1 [M])."""
    man = jnp.sum(jnp.abs(h_m - h_c), axis=-1)
    dot = jnp.sum(h_m * h_c, axis=-1)
    cols = []
    for flag in singles:
        if flag == F.FEAT_LD:
            v = jnp.abs(len_m - len_c)
        elif flag == F.FEAT_MANHATTAN:
            v = man
        elif flag == F.FEAT_INTERSECTION:
            v = (mag_m + mag_c - man) / (mag_m + mag_c)
        elif flag == F.FEAT_KULCZYNSKI2:
            ap = mag_m / V
            aq = mag_c / V
            v = V * (ap + aq) / (2.0 * ap * aq) * (mag_m + mag_c - man) * 0.5
        elif flag == F.FEAT_SIMRATIO:
            norm2 = jnp.maximum(sq_m + sq_c - 2.0 * dot, 0.0)
            v = dot / (dot + jnp.sqrt(norm2))
        elif flag == F.FEAT_PEARSON:
            ap = jnp.floor(mag_m / V + 0.5)
            aq = jnp.floor(mag_c / V + 0.5)
            np_ = sq_m - 2.0 * ap * mag_m + V * ap * ap
            nq_ = sq_c - 2.0 * aq * mag_c + V * aq * aq
            dotc = dot - ap * mag_c - aq * mag_m + V * ap * aq
            v = dotc / jnp.sqrt(jnp.maximum(0.5, np_ * nq_))
        else:
            raise AssertionError(flag)
        cols.append(v)
    cache = jnp.stack(cols, axis=-1)
    norm = (cache - prm.mins) / (prm.maxs - prm.mins)
    norm = jnp.where(prm.is_sim, norm, 1.0 - norm)
    score = jnp.full(cache.shape[:-1], prm.weights[0])
    f1 = None
    for j, (combo, idx) in enumerate(combos):
        prod = jnp.ones(cache.shape[:-1], jnp.float32)
        for i in idx:
            c = norm[..., i]
            prod = prod * (c * c if combo == F.COMBO_SQUARED else c)
        if j == 0:
            f1 = prod
        score = score + prm.weights[j + 1] * prod
    return score >= 0.0, f1


def make_update_step(mesh: Mesh, V: int, delta: int, singles, combos):
    """Build the pjit'ed one-iteration update step over `mesh` ('data',).

    Member arrays are sharded on axis 0; center arrays replicated. Returns
    new center selections [C] (global member ids) — identical to the
    sequential semantics up to f32 tie-breaking.
    """
    dsh = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def step(m_hist, m_mag, m_sq, m_len, m_assign, m_gid,
             c_hist, c_mag, c_sq, c_len, prm):
        C = c_hist.shape[0]
        # pass 1: banded classify + masked mean accumulation
        pos_any = jnp.zeros((m_hist.shape[0],), bool)
        sums = jnp.zeros((C, V), jnp.float32)
        counts = jnp.zeros((C,), jnp.float32)
        member_pos = []
        for o in range(-delta, delta + 1):
            j = jnp.clip(m_assign + o, 0, C - 1)
            in_band = (m_assign + o >= 0) & (m_assign + o <= C - 1)
            pos, _ = _classify_cols(
                m_hist, c_hist[j], m_mag, c_mag[j], m_sq, c_sq[j],
                m_len, c_len[j], V, singles, combos, prm)
            w = (pos & in_band).astype(jnp.float32)
            member_pos.append(pos & in_band)
            onehot = (jax.nn.one_hot(j, C, dtype=jnp.float32) * w[:, None])
            sums = sums + jnp.dot(onehot.T, m_hist, precision=F.HIGHEST)
            counts = counts + onehot.sum(axis=0)
        sums = jax.lax.psum(sums, "data")
        counts = jax.lax.psum(counts, "data")
        mean = sums / jnp.maximum(counts, 1.0)[:, None]      # [C, V]

        # pass 2: per-center argmin distance_d over positive members
        best_d = jnp.full((C,), jnp.inf, jnp.float32)
        best_id = jnp.full((C,), jnp.iinfo(jnp.int32).max, jnp.int32)
        for o_i, o in enumerate(range(-delta, delta + 1)):
            j = jnp.clip(m_assign + o, 0, C - 1)
            cmean = mean[j]                                   # [M, V]
            cw = jnp.floor(cmean)
            dist = 2.0 * jnp.sum(jnp.minimum(m_hist, cw), axis=-1)
            mag = jnp.sum(jnp.floor(m_hist + cmean), axis=-1)
            frac = dist / mag
            d = 10000.0 * (1.0 - frac * frac)
            d = jnp.where(member_pos[o_i], d, jnp.inf)
            oh = jax.nn.one_hot(j, C, dtype=jnp.float32)
            dj = jnp.where(oh.T > 0, d[None, :], jnp.inf)     # [C, M]
            dmin = jnp.min(dj, axis=1)
            # lexicographic (dist, global id) winner within the shard
            is_min = dj == dmin[:, None]
            gid_masked = jnp.where(is_min, m_gid[None, :],
                                   jnp.iinfo(jnp.int32).max)
            win_id = jnp.min(gid_masked, axis=1)
            upd = dmin < best_d
            best_d = jnp.where(upd, dmin, best_d)
            best_id = jnp.where(upd, win_id.astype(jnp.int32), best_id)
        # merge across shards: lexicographic (dist, gid) min via psum trick
        all_d = jax.lax.all_gather(best_d, "data")            # [n, C]
        all_id = jax.lax.all_gather(best_id, "data")
        gmin = jnp.min(all_d, axis=0)
        id_masked = jnp.where(all_d == gmin[None, :], all_id,
                              jnp.iinfo(jnp.int32).max)
        gid = jnp.min(id_masked, axis=0)
        return gid, gmin, mean

    pstep = jax.jit(
        jax.shard_map(
            step, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data"), P("data"), P("data"),
                      P("data"), P(), P(), P(), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        ))
    return pstep


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=("data",))
