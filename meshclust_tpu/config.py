"""Run configuration mirroring the reference CLI flags.

Reference: Runner::get_opts (/root/reference/src/cluster/src/Runner.cpp:150-263)
and constructor defaults (Runner.cpp:25-39, Runner.h:15-36).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ClusterConfig:
    """All knobs of a clustering run.

    Defaults follow the reference *code* (not its README, which disagrees:
    sample_size 3000 vs README 1500, pivots 20 vs README 40 — SURVEY §5.6).
    """

    files: list = dataclasses.field(default_factory=list)
    similarity: float = 0.90          # --id
    kmer: Optional[int] = None        # --kmer (None => auto, Runner.cpp:265-292)
    output: str = "output.clstr"      # --output
    delta: int = 5                    # --delta
    iterations: int = 15              # --iterations
    align: bool = False               # --align (forced if similarity < 0.60)
    sample_size: int = 0              # --sample (0 => 3000, Runner.cpp:35-37)
    pivots: int = 20                  # --pivot (max pairs from one pivot)
    threads: Optional[int] = None     # --threads (host-side parallelism hint)

    # Scoring matrix for alignment labels: match, mismatch, gap open, gap cont
    # (Trainer.cpp:25-27 invokes GlobAlignE with (1, -1, 2, 1)).
    match: int = 1
    mismatch: int = -1
    gap_open: int = 2
    gap_continue: int = 1

    # Engine knobs (no reference analogue)
    bin_size: int = 1000              # bvec bin size (Runner.cpp:342)
    acc_cutoff: float = 97.5          # Trainer::train default (Trainer.h:36)
    exact: bool = False               # float64 host decisions (tests/debug)
    seed: int = 10                    # srand(10) analogue (Runner.cpp:38)
    checkpoint: Optional[str] = None  # milestone save/resume prefix (§5.4)

    def finalize(self) -> "ClusterConfig":
        """Apply the reference's constructor rules (Runner.cpp:25-39)."""
        cfg = dataclasses.replace(self)
        if cfg.similarity < 0.6:
            cfg.align = True
        if cfg.sample_size == 0:
            cfg.sample_size = 3000
        return cfg
