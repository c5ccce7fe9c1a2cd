"""Test environment, set up before jax is imported.

CPU tier (default): JAX on the CPU with 8 virtual devices for the sharding
tests, x64 on, and no persistent compile cache (CPU executables are pinned
to the host's CPU features). Numeric kernels are checked against scalar
numpy oracles in tests/ref_impl.py, Pallas kernels in interpret mode.

GPU tier (MESHCLUST_TEST_GPU=1): the real backend with x64 off, as the CLI
runs. `python -m pytest tests/ -m gpu` selects the tests that need the
card; the `gpu` fixture skips them where JAX finds none.
"""
import os

_GPU_TIER = os.environ.get("MESHCLUST_TEST_GPU") == "1"
if not _GPU_TIER:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

if not _GPU_TIER:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The CUDA device the test needs; skips where JAX finds none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run MESHCLUST_TEST_GPU=1 "
                    "python -m pytest tests/ -m gpu on the card")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_dna(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


def mutate(rng, seq, rate):
    """Point-mutate a DNA string at the given rate (for synthetic clusters)."""
    bases = "ACGT"
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate * 0.8:      # substitution
            out.append(bases[int(rng.integers(4))])
        elif r < rate * 0.9:    # deletion
            continue
        elif r < rate:          # insertion
            out.append(ch)
            out.append(bases[int(rng.integers(4))])
        else:
            out.append(ch)
    return "".join(out)


@pytest.fixture
def make_fasta(tmp_path):
    def _make(records, name="test.fasta"):
        p = tmp_path / name
        with open(p, "w") as f:
            for header, seq in records:
                f.write(f">{header}\n")
                for i in range(0, len(seq), 70):
                    f.write(seq[i:i + 70] + "\n")
        return str(p)

    return _make
