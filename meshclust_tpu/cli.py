"""CLI mirroring the reference flags (Runner::get_opts, Runner.cpp:150-263).

Usage: python -m meshclust_tpu.cli *.fasta [--id 0.90] [--kmer K] [--delta 5]
       [--output output.clstr] [--iterations 15] [--align] [--sample 3000]
       [--pivot 20] [--threads N]
"""
from __future__ import annotations

import argparse
import sys

from meshclust_tpu.config import ClusterConfig
from meshclust_tpu.core.runner import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meshclust",
        description="DNA mean-shift clustering on an accelerator "
                    "(MeShClust-capability engine)")
    p.add_argument("files", nargs="+", help="input FASTA files")
    p.add_argument("--id", dest="similarity", type=float, default=0.90,
                   help="identity cutoff in (0,1) (default 0.90)")
    p.add_argument("-k", "--kmer", type=int, default=None,
                   help="k-mer size (default: auto from average length)")
    p.add_argument("-o", "--output", default="output.clstr",
                   help="output CLSTR file")
    p.add_argument("-a", "--align", action="store_true",
                   help="force alignment-based classification")
    p.add_argument("-s", "--sample", dest="sample_size", type=int, default=0,
                   help="total training+testing sample pairs (default 3000)")
    p.add_argument("-p", "--pivot", dest="pivots", type=int, default=20,
                   help="max pairs from one pivot (default 20)")
    p.add_argument("-d", "--delta", type=int, default=5,
                   help="cluster look-around window (default 5)")
    p.add_argument("-i", "--iter", "--iterations", dest="iterations",
                   type=int, default=15, help="update+merge iterations")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="host thread hint (device path ignores this)")
    p.add_argument("--exact", action="store_true",
                   help="float64 host classifier (slow, parity debugging)")
    p.add_argument("--checkpoint", default=None, metavar="PREFIX",
                   help="save/resume run milestones (trained classifier + "
                        "Phase-A centers) under PREFIX.{model,centers}.json")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (0.0 < args.similarity < 1.0):
        print("Similarity must be between 0 and 1", file=sys.stderr)
        return 1
    if args.kmer is not None and args.kmer <= 0:
        print("K must be greater than 0.", file=sys.stderr)
        return 1
    cfg = ClusterConfig(
        files=list(args.files),
        similarity=args.similarity,
        kmer=args.kmer,
        output=args.output,
        align=args.align,
        sample_size=args.sample_size,
        pivots=args.pivots,
        delta=args.delta,
        iterations=args.iterations,
        threads=args.threads,
        exact=args.exact,
        checkpoint=args.checkpoint,
    )
    res = run(cfg)
    print(f"Wrote {res['n_clusters']} clusters to {cfg.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
