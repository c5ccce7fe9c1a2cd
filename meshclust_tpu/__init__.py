"""meshclust-tpu: DNA sequence mean-shift clustering on an accelerator.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
BioinformaticsToolsmith/MeShClust (James et al., NAR 2018).
"""

__version__ = "0.1.0"

from meshclust_tpu.config import ClusterConfig  # noqa: F401
