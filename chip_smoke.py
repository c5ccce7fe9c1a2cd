#!/usr/bin/env python
"""Smoke test of meshclust on an NVIDIA GPU: the main path, end to end, at
real size, checked against the repo's own references.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # only the 4-card mesh against 1 card

Phases, in one process (a JAX process reserves most of the card):

 1. device: JAX must find a GPU; prints its kind and count, nvidia-smi's
    name and power limit, the JAX version and XLA_FLAGS.
 2. kernel parity at real widths: the aligner kernel against the XLA scan
    on a 3000-pair labeling batch and an align-mode batch of 1 kb pairs
    (exact integer counts), and the double-single / certified classifier
    decisions against host float64 at 150k-corpus statistics.
 3. the GPU test tier (pytest -m gpu, in this process).
 4. k-mer path: 15k x 1 kb at --id 0.90 through the CLI; the partition
    must equal the --exact float64 host oracle's, member for member.
 5. align path: the 6 x 500 viral mix at --id 0.50 (align mode), against
    --exact likewise.
 6. real size: 150k x 1 kb at --id 0.90: cold and warm walls, phase times,
    purity/NMI against the planted truth, peak device memory; the fused
    Phase B must not have fallen back to the host.

Every phase prints one line; the first failure ends the run with a non-zero
exit. The last line of stdout is one JSON object naming the device.
Generated data and outputs go to .smoke/ in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
sys.path.insert(0, ROOT)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, phase: str, msg: str) -> None:
    if not ok:
        say(phase, f"FAIL: {msg}")
        sys.exit(1)


# -- phase 1 -----------------------------------------------------------------

def phase_device(expect: int):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu", "device",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= expect, "device",
          f"{len(devs)} GPU(s), this run needs {expect}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    say("device", f"{devs[0].device_kind} x{len(devs)}; jax "
        f"{jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for line in smi.strip().splitlines():
        print(line.strip(), flush=True)
    return devs


# -- phase 2 -----------------------------------------------------------------

def family_codes(rng, n_fam: int, per: int, lo: int, hi: int,
                 rate: tuple):
    """Sequences in families: a random base of length lo..hi per family,
    clones with substitution rate in [rate[0], rate[1]) and trimmed ends."""
    import numpy as np
    codes = []
    for _ in range(n_fam):
        base = rng.integers(0, 4, int(rng.integers(lo, hi + 1)),
                            dtype=np.uint8)
        for _ in range(per):
            c = base.copy()
            m = rng.random(c.shape[0]) < rng.uniform(*rate)
            c[m] = (c[m] + rng.integers(1, 4, int(m.sum()))) % 4
            codes.append(c[: c.shape[0] - int(rng.integers(0, 20))])
    return codes


def timed_counts(aligner, pairs):
    """(counts, warm seconds) of one call after a compiling one."""
    aligner.counts(pairs)
    t = time.perf_counter()
    out = aligner.counts(pairs)
    return out, time.perf_counter() - t


def phase_kernels(n_pairs: int = 3000, seed: int = 0) -> None:
    import numpy as np
    from meshclust_tpu.ops.align_device import DeviceAligner
    rng = np.random.default_rng(seed)
    # labeling batch: 3000 pairs over 1 kb families (bench spread 900-1100)
    per = 50
    codes = family_codes(rng, 40, per, 900, 1100, (0.01, 0.05))
    ia = rng.integers(0, len(codes), n_pairs)
    ib = np.where(rng.random(n_pairs) < 0.5,         # same family or any
                  np.minimum(ia // per * per + rng.integers(0, per, n_pairs),
                             len(codes) - 1),
                  rng.integers(0, len(codes), n_pairs))
    pairs = [(int(a), int(b)) for a, b in zip(ia, ib)]
    # align-mode batch: every candidate of a window against one center, on
    # the viral mix's shape (1.1-1.3 kb, 12-22% substitutions)
    vcodes = family_codes(rng, 6, 250, 1100, 1300, (0.12, 0.22))
    vpairs = [(j, 0) for j in range(1, len(vcodes))]
    for name, cs, ps in (("labeling", codes, pairs),
                         ("align-mode", vcodes, vpairs)):
        kern = DeviceAligner(cs)
        check(kern.kernel, "kernels", "aligner kernel not chosen on a GPU")
        (al, am), t_k = timed_counts(kern, ps)
        (el, em), t_x = timed_counts(DeviceAligner(cs, use_kernel=False), ps)
        bad = int(((al != el) | (am != em)).sum())
        check(bad == 0, "kernels",
              f"{name}: {bad}/{len(ps)} pairs differ from the XLA scan")
        say("kernels", f"aligner {name} batch: {len(ps)} pairs exact vs XLA "
            f"scan (tolerance 0); kernel {t_k:.4f}s, XLA scan {t_x:.4f}s")
    _decisions(rng)


def _host_score(params, st, V: int):
    """Float64 classifier score and f1, the HostBackend arithmetic."""
    import numpy as np
    from meshclust_tpu.ops import features as F
    cols = [F.raw_from_sums(f, V=V, **st) for f in params.singles]
    norm = (np.stack(cols, -1) - params.mins) / (params.maxs - params.mins)
    norm = np.where(params.is_sim, norm, 1.0 - norm)
    score = np.full(st["man"].shape[0], params.weights[0])
    f1 = None
    for j, (combo, idx) in enumerate(params.combos):
        prod = np.ones_like(score)
        for i in idx:
            prod = prod * (norm[:, i] ** 2 if combo == F.COMBO_SQUARED
                           else norm[:, i])
        f1 = prod if j == 0 else f1
        score = score + params.weights[j + 1] * prod
    return score, f1


def _decisions(rng) -> None:
    """DS and certified decisions against float64 on pair statistics of
    1 kb reads at k=4 (V=256), the 150k corpus's regime."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import __graft_entry__ as g
    from meshclust_tpu.ops import certify as CT
    from meshclust_tpu.ops import ds_classify as DSC
    from meshclust_tpu.ops import histogram as H
    V, k = 256, 4
    codes = family_codes(rng, 64, 32, 900, 1100, (0.0, 0.08))
    L = 1152
    mat = np.zeros((len(codes), L), np.uint8)
    lens = np.array([len(c) for c in codes], np.int32)
    for i, c in enumerate(codes):
        mat[i, : len(c)] = c
    hist = np.asarray(H.featurize_batch_simple(
        jnp.asarray(mat), jnp.asarray(lens), k, 1)[0]).astype(np.int64)
    n = 16384
    ia = rng.integers(0, len(codes), n)
    ib = np.where(rng.random(n) < 0.5,                # same family or any
                  np.minimum(ia // 32 * 32 + rng.integers(0, 32, n),
                             len(codes) - 1),
                  rng.integers(0, len(codes), n))
    ha, hb = hist[ia], hist[ib]
    st = dict(man=np.abs(ha - hb).sum(1).astype(np.float64),
              dot=(ha * hb).sum(1).astype(np.float64),
              mag_a=ha.sum(1).astype(np.float64),
              mag_b=hb.sum(1).astype(np.float64),
              sq_a=(ha * ha).sum(1).astype(np.float64),
              sq_b=(hb * hb).sum(1).astype(np.float64),
              len_a=lens[ia].astype(np.float64),
              len_b=lens[ib].astype(np.float64))
    _, _, _, _, params = g._toy_model(V=V)
    score64, f164 = _host_score(params, st, V)
    cb = DSC.const_block(params)
    singles = tuple(params.singles)
    combos = tuple((c, tuple(i)) for c, i in params.combos)
    order = ("man", "dot", "mag_a", "mag_b", "sq_a", "sq_b", "len_a",
             "len_b")
    args = [jnp.asarray(st[key], jnp.float32) for key in order]

    @jax.jit
    def run(*a):
        ds = DSC.score(singles, combos, jnp.asarray(cb["mins2"]),
                       jnp.asarray(cb["spans2"]), jnp.asarray(cb["is_sim"]),
                       jnp.asarray(cb["weights2"]), *a, V)
        ct = CT.score(singles, combos, jnp.asarray(cb["mins2"][0]),
                      jnp.asarray(cb["spans2"][0]),
                      jnp.asarray(cb["is_sim"]),
                      jnp.asarray(cb["weights2"][0]), *a, V)
        return ds, ct

    (pos, f1h, f1l), (s, eps, _, _) = jax.tree_util.tree_map(
        np.asarray, run(*args))
    clear = np.abs(score64) > 1e-10
    bad_ds = int((pos[clear] != (score64 >= 0)[clear]).sum())
    f1_err = float(np.max(np.abs(f1h.astype(np.float64) + f1l - f164)
                          / np.maximum(1.0, np.abs(f164))))
    over = int((np.abs(s.astype(np.float64) - score64) > eps).sum())
    sure = np.abs(s) > eps
    bad_ct = int(((s[sure] >= 0) != (score64[sure] >= 0)).sum())
    check(bad_ds == 0 and f1_err <= 1e-12, "kernels",
          f"DS: {bad_ds} decisions differ from float64, f1 error {f1_err:.3g}")
    check(over == 0 and bad_ct == 0, "kernels",
          f"certified: {over} bounds exceeded, {bad_ct} certain decisions "
          "differ from float64")
    say("kernels", f"DS decisions: {n} pairs equal float64 where |score| > "
        f"1e-10 ({int(clear.sum())}), f1 error {f1_err:.3g} <= 1e-12; "
        f"certified: bounds hold on all {n}, {int(sure.sum())} certain, "
        "all equal float64")


# -- phase 3 -----------------------------------------------------------------

def phase_gpu_tests() -> None:
    os.environ["MESHCLUST_TEST_GPU"] = "1"
    import pytest

    class Tally:
        def __init__(self):
            self.counts = defaultdict(int)

        def pytest_runtest_logreport(self, report):
            if report.failed:
                self.counts["failed"] += 1
            elif report.skipped:
                self.counts["skipped"] += 1
            elif report.when == "call":
                self.counts["passed"] += 1

    tally = Tally()
    t = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_hw.py")],
                     plugins=[tally])
    c = tally.counts
    check(rc == 0 and c["failed"] == 0 and c["skipped"] == 0
          and c["passed"] > 0, "gpu-tests",
          f"pytest rc {rc}: {dict(c)}")
    say("gpu-tests", f"pytest -m gpu: {c['passed']} passed, 0 failed, "
        f"0 skipped ({time.perf_counter() - t:.1f}s)")


# -- phases 4-6 --------------------------------------------------------------

def partition(path: str):
    import bench
    groups = defaultdict(set)
    for member, cid in bench.read_members(path).items():
        groups[cid].add(member)
    return {frozenset(g) for g in groups.values()}


def run_cli(phase: str, fasta: str, out: str, *flags: str) -> float:
    """One CLI run; returns its wall seconds."""
    from meshclust_tpu.cli import main as cli_main
    from meshclust_tpu.utils import perf
    perf.reset()
    t = time.perf_counter()
    rc = cli_main([fasta, "-o", out, *flags])
    wall = time.perf_counter() - t
    check(rc == 0, phase, f"CLI {' '.join(flags)} exited {rc}")
    check(perf.counters().get("phase_b_replay_fallbacks", 0) == 0, phase,
          "fused Phase B fell back to the host path")
    return wall


def phase_parity(phase: str, fasta: str, ident: str) -> None:
    dev = os.path.join(WORK, f"{phase}.clstr")
    exact = os.path.join(WORK, f"{phase}_exact.clstr")
    t_dev = run_cli(phase, fasta, dev, "--id", ident)
    t_exact = run_cli(phase, fasta, exact, "--id", ident, "--exact")
    a, b = partition(dev), partition(exact)
    n = sum(len(g) for g in a)
    check(a == b, phase, f"partition differs from --exact: "
          f"{len(a ^ b)} clusters not shared")
    say(phase, f"{os.path.basename(fasta)} --id {ident}: {len(a)} clusters "
        f"of {n} sequences equal --exact member for member "
        f"(device {t_dev:.1f}s, exact {t_exact:.1f}s)")


def phase_real_size(fasta: str) -> None:
    import jax
    import bench
    from meshclust_tpu.utils import perf
    out = os.path.join(WORK, "real.clstr")
    cold = run_cli("real-size", fasta, out, "--id", "0.90")
    warm = run_cli("real-size", fasta, out, "--id", "0.90")
    rep = perf.report()
    q = bench.cluster_quality(out)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    phases = ", ".join(f"{k} {v:.2f}s" for k, v in sorted(
        rep["phases_s"].items(), key=lambda kv: -kv[1]))
    say("real-size", f"150k x 1kb --id 0.90: cold {cold:.2f}s, warm "
        f"{warm:.2f}s; phases (warm) {phases}")
    say("real-size", f"purity {q['purity']}, NMI {q['nmi']}, "
        f"{q['n_clusters']} clusters; peak device memory {peak} bytes; "
        "Phase B fallbacks 0")
    check(q["purity"] > 0.99, "real-size", f"purity {q['purity']}")


def phase_four(fasta: str) -> None:
    mesh_out = os.path.join(WORK, "four_mesh.clstr")
    one_out = os.path.join(WORK, "four_one.clstr")
    os.environ.pop("MESHCLUST_DEVICES", None)
    t4 = run_cli("four", fasta, mesh_out, "--id", "0.90")
    os.environ["MESHCLUST_DEVICES"] = "1"
    t1 = run_cli("four", fasta, one_out, "--id", "0.90")
    del os.environ["MESHCLUST_DEVICES"]
    with open(mesh_out, "rb") as f4, open(one_out, "rb") as f1:
        same = f4.read() == f1.read()
    check(same, "four", "4-card CLSTR differs from the 1-card CLSTR")
    say("four", f"150k x 1kb --id 0.90: 4-card mesh {t4:.2f}s (cold), "
        f"1 card {t1:.2f}s; CLSTR byte-equal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-card mesh run and its 1-card reference")
    args = ap.parse_args(argv)
    import meshclust_tpu  # noqa: F401  (fails outside a checkout)
    import bench
    devs = phase_device(4 if args.four else 1)
    os.makedirs(WORK, exist_ok=True)
    if args.four:
        phase_four(bench.make_dataset(150000, directory=WORK))
    else:
        phase_kernels()
        phase_gpu_tests()
        phase_parity("kmer-parity", bench.make_dataset(15000, directory=WORK),
                     "0.90")
        phase_parity("align-parity", bench.make_viral_dataset(directory=WORK),
                     "0.50")
        phase_real_size(bench.make_dataset(150000, directory=WORK))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
