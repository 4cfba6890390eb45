"""COSMOS in PyTorch with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``, module for module: the DSE
engine (:mod:`repro_torch.core`), the WAMI case study
(:mod:`repro_torch.apps.wami`), the fleet app (:mod:`repro_torch.apps.fleet`,
with the model configs it prices, :mod:`repro_torch.configs`) and their
measured kernels (:mod:`repro_torch.kernels`, sources under ``csrc/``).
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
