"""Distributed runtime wiring for the production pipeline (SURVEY §5.8).

The reference has no distributed code (OpenMP shared memory only); this
design shards over a 1-D "data" mesh of all local devices. On a host whose
GPUs are joined all to all (NVLink), every device reaches every other at the
same rate, so one flat axis is the whole layout:

  - featurization: histogram batches sharded on the batch axis — pure SPMD,
    XLA partitions the histogram scatter with zero collectives;
  - fused Phase B (update+merge loop): member pools sharded, centers
    replicated; per-iteration psum of (sum histograms, counts) and a
    lexicographic (distance, global-pool-position) min across shards — the
    deterministic global-id tie-break that makes N-device output equal
    1-device output (see core/classify._build_phaseb);
  - Phase A (accumulate) is sequential by contract (each absorb changes the
    candidate store for the next step), so it shards the FEATURE axis
    instead: each device holds [N, V/n] and psums exact integer partials
    (core/accumulate_device.py).

Multi-host: call init_distributed() before anything else; jax.distributed
wires the hosts into one global device list and the same mesh code runs
across them.

Determinism note: every cross-shard reduction here either sums integers
held exactly in f32 (histogram counts < 2^24) or takes lexicographic mins,
so device count does not change results bitwise.

Knobs: MESHCLUST_DEVICES=N forces the mesh size (N=1 disables);
default = all local devices.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init_distributed() -> None:
    """Multi-host init hook (jax.distributed). No-op unless the standard
    coordinator env vars are set, so single-host runs never pay for it."""
    if os.environ.get("MESHCLUST_COORDINATOR"):
        import jax
        jax.distributed.initialize(
            coordinator_address=os.environ["MESHCLUST_COORDINATOR"],
            num_processes=int(os.environ.get("MESHCLUST_NUM_PROCS", "1")),
            process_id=int(os.environ.get("MESHCLUST_PROC_ID", "0")))


def get_mesh(n_devices: Optional[int] = None):
    """The pipeline's 1-D "data" mesh, or None for the single-device path."""
    import jax
    from jax.sharding import Mesh
    if n_devices is None:
        env = os.environ.get("MESHCLUST_DEVICES")
        n_devices = int(env) if env else len(jax.devices())
    n_devices = min(n_devices, len(jax.devices()))
    if n_devices <= 1:
        return None
    return Mesh(np.array(jax.devices()[:n_devices]), axis_names=("data",))


def is_multiprocess() -> bool:
    import jax
    return jax.process_count() > 1


def put(mesh, spec, a):
    """Multiprocess-safe device_put of a host array every process holds in
    full: each process contributes only its addressable shards
    (jax.make_array_from_callback), so the same code runs on a single-host
    mesh and on a multi-host one."""
    import jax
    from jax.sharding import NamedSharding
    sh = NamedSharding(mesh, spec)
    if not is_multiprocess():
        return jax.device_put(a, sh)
    a = np.asarray(a)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])


def fetch(x) -> np.ndarray:
    """Multiprocess-safe readback: np.asarray when every shard is local;
    otherwise reshard to fully-replicated (an all_gather) first — a
    fully-replicated global array converts to numpy on every host."""
    import jax
    if not hasattr(x, "sharding") or x.is_fully_addressable:
        return np.asarray(x)
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = x.sharding.mesh
    rep = jax.jit(lambda a: a,
                  out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep)


def shard_batch(mesh, *arrays):
    """device_put host batches sharded on axis 0 (pads to the mesh size).

    Returns (padded_arrays..., real_rows). XLA then partitions any jit that
    consumes them along the batch axis automatically."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    n = mesh.devices.size
    B = arrays[0].shape[0]
    Bp = ((B + n - 1) // n) * n
    sh = NamedSharding(mesh, P("data"))
    out = []
    for a in arrays:
        if Bp != B:
            pad = [(0, Bp - B)] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(a, pad)
        out.append(jax.device_put(a, sh))
    return (*out, B)
