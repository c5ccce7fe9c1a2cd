"""Run orchestration (Runner re-design, SURVEY C2).

Pipeline (Runner.cpp:25-90, 321-375): input collection (basename-sorted),
auto-k, featurization, dtype scan, training, bvec fill, mean-shift, CLSTR.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from meshclust_tpu.config import ClusterConfig
from meshclust_tpu.core import classify as C
from meshclust_tpu.core.bvec import BVec
from meshclust_tpu.core.meanshift import MeanShift
from meshclust_tpu.core.points import PointSet, build_points
from meshclust_tpu.core.trainer import Trainer
from meshclust_tpu.errors import FileDoesNotExistError
from meshclust_tpu.io import fasta as fio
from meshclust_tpu.io.clstr import write_clstr
from meshclust_tpu.ops import histogram as H
from meshclust_tpu.utils.log import log
from meshclust_tpu.utils import perf


def sort_files(files: List[str]) -> List[str]:
    """Inputs sorted by basename (Runner.cpp:253-262)."""
    return sorted(files, key=lambda p: os.path.basename(p))


def run(cfg: ClusterConfig) -> dict:
    from meshclust_tpu.utils import jaxcache
    from meshclust_tpu.parallel import dist
    dist.init_distributed()   # MUST precede any backend-initializing call
    jaxcache.enable()
    trace_dir = os.environ.get("MESHCLUST_TRACE")
    if trace_dir:
        # device-level kernel timings (SURVEY §5.1): view with
        # tensorboard's profile plugin or xprof; complements the
        # cells/s + utilization counters in utils/perf.py
        import jax
        with jax.profiler.trace(trace_dir):
            return _run(cfg)
    return _run(cfg)


def _run(cfg: ClusterConfig) -> dict:
    from meshclust_tpu.parallel import dist
    mesh = dist.get_mesh()
    if mesh is not None:
        log(f"Mesh: {mesh.devices.size} devices (data-parallel)")
    cfg = cfg.finalize()
    files = sort_files(list(cfg.files))
    if not files:
        raise FileDoesNotExistError("no input files")
    for f in files:
        if not os.path.isfile(f):
            raise FileDoesNotExistError(f'File "{f}" does not exist')

    log("Reading in sequences")
    with perf.phase("read"):
        per_file = [fio.read_fasta(f) for f in files]
    seqs = [s for fs in per_file for s in fs]
    if not seqs:
        raise FileDoesNotExistError("no sequences found")

    k = cfg.kmer if cfg.kmer is not None else H.find_k(per_file)
    k = max(1, k)
    log(f"Using k = {k}")

    log(f"Counting {k}-mers")
    with perf.phase("featurize"):
        ps = build_points(seqs, k, mesh=mesh)
    largest_count = ps.largest
    bits = int(np.dtype(H.storage_dtype(largest_count)).itemsize * 8)
    log(f"Using {bits} bit histograms")

    from meshclust_tpu.ops.align_device import DeviceAligner
    aligner = DeviceAligner(ps.codes, match=cfg.match, mismatch=cfg.mismatch,
                            go=cfg.gap_open, gc=cfg.gap_continue)

    trainer = Trainer(
        ps, n_points=cfg.sample_size, cutoff=cfg.similarity,
        max_pts_from_one=cfg.pivots, k=0 if cfg.align else k,
        exact=cfg.exact)
    if (cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_continue) \
            == (1, -1, 2, 1):
        trainer._dev_aligner = aligner   # share the staged codes
    else:
        trainer._dev_aligner = DeviceAligner(ps.codes)
    from meshclust_tpu.utils import checkpoint as ckpt
    tk = 0 if cfg.align else k
    model = None
    if cfg.checkpoint:
        model = ckpt.load_model(cfg.checkpoint + ".model.json", ps, tk,
                                cfg.similarity, cfg.seed, cfg)
        if model is not None:
            log("Resumed trained classifier from checkpoint")
    if model is None:
        with perf.phase("train"):
            model = trainer.train(cfg.acc_cutoff)
        if cfg.checkpoint:
            ckpt.save_model(cfg.checkpoint + ".model.json", model, ps,
                            cfg.seed, cfg)

    params = model.params

    def align_fn(center: int, idxs: np.ndarray) -> np.ndarray:
        # (candidate, center) orientation — GlobAlignE identity depends on
        # operand order via gap tie-breaks; the reference's classify sites
        # put the center SECOND (Trainer.cpp:88,:150,:341)
        return aligner.identities([(int(j), center) for j in idxs])

    backend = C.make_backend(ps, params, align_fn=align_fn, exact=cfg.exact,
                             mesh=mesh, aligner=aligner)

    bv = BVec(ps.lengths.copy(), cfg.bin_size)
    bv.bulk_insert(ps.lengths)
    bv.insert_finalize()

    ms = MeanShift(ps, backend, sim=cfg.similarity, delta=cfg.delta,
                   iterations=cfg.iterations)
    resume = None
    on_acc = None
    if cfg.checkpoint:
        cpath = cfg.checkpoint + ".centers.json"
        resume = ckpt.load_centers(cpath, ps, tk, cfg.similarity, cfg.seed,
                                   cfg)
        on_acc = lambda cs: ckpt.save_centers(  # noqa: E731
            cpath, cs, ps, tk, cfg.similarity, cfg.seed, cfg)
    with perf.phase("cluster"):
        centers = ms.run(bv, resume_centers=resume, on_accumulated=on_acc)

    log("Printing output")
    with perf.phase("output"):
        write_clstr(cfg.output, centers, ps.headers, ps.lengths)
    if os.environ.get("MESHCLUST_PERF", "0") == "1":
        import sys
        print(perf.format_report(), file=sys.stderr, flush=True)
    return {
        "centers": centers,
        "pointset": ps,
        "model": model,
        "k": k,
        "n_clusters": sum(1 for c in centers if c.members),
    }
