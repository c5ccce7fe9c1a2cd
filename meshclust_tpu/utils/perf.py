"""Phase timing + throughput counters (SURVEY §5.1).

The reference's only observability was Progress bars and cout phase lines;
its validation was external timing tables (/root/reference/Tables/Real.csv).
Here every pipeline phase is timed, and the two numeric hot paths export
work counters so the bench can report:

  - sequences/s        (the BASELINE.json headline)
  - NW cells/s         (sum of l1*l2 over aligned pairs / align wall time)
  - classify rows/s    (candidate rows pushed through the classifier)
  - Phase A GB/s       (histogram bytes the absorb sweeps stream / time)

Usage:
    with perf.phase("training"):
        ...
    perf.add("nw_cells", l1 @ l2)
    perf.report()   -> dict        perf.format_report() -> str
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

_phase_s: Dict[str, float] = defaultdict(float)
_phase_n: Dict[str, int] = defaultdict(int)
_counters: Dict[str, float] = defaultdict(float)
_t0 = time.time()


def reset() -> None:
    _phase_s.clear()
    _phase_n.clear()
    _counters.clear()
    global _t0
    _t0 = time.time()


@contextlib.contextmanager
def phase(name: str):
    t = time.time()
    try:
        yield
    finally:
        _phase_s[name] += time.time() - t
        _phase_n[name] += 1


def add(counter: str, amount: float) -> None:
    _counters[counter] += float(amount)


def counters() -> Dict[str, float]:
    return dict(_counters)


def phases() -> Dict[str, float]:
    return dict(_phase_s)


def report() -> dict:
    out: dict = {"wall_s": time.time() - _t0,
                 "phases_s": dict(_phase_s),
                 "phase_calls": dict(_phase_n),
                 "counters": dict(_counters)}
    align_s = _phase_s.get("align", 0.0)
    cells = _counters.get("nw_cells", 0.0)
    if align_s > 0 and cells > 0:
        out["nw_cells_per_s"] = cells / align_s
    cls_s = _phase_s.get("cluster", 0.0)
    rows = _counters.get("classify_rows", 0.0)
    if cls_s > 0 and rows > 0:
        out["classify_rows_per_s"] = rows / cls_s
    # Phase A streams the histogram in every absorb sweep: bytes/s is the
    # axis to hold against the device's memory bandwidth
    acc_s = _phase_s.get("accumulate", 0.0)
    sweep_b = _counters.get("accum_sweep_bytes", 0.0)
    if acc_s > 0 and sweep_b > 0:
        out["accum_gbps"] = sweep_b / acc_s / 1e9
    return out


def format_report() -> str:
    r = report()
    lines = [f"total wall: {r['wall_s']:.2f}s"]
    for k, v in sorted(r["phases_s"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  phase {k:<14s} {v:8.2f}s  x{r['phase_calls'][k]}")
    for k, v in sorted(r["counters"].items()):
        lines.append(f"  counter {k:<18s} {v:.3g}")
    for k in ("nw_cells_per_s", "classify_rows_per_s", "accum_gbps"):
        if k in r:
            lines.append(f"  {k}: {r[k]:.3g}")
    return "\n".join(lines)
