"""safediffcon_torch — the PyTorch + CUDA port of SafeDiffCon.

A second package beside `safediffcon_tpu/`, which stays the reference. Each
module here mirrors the JAX module of the same path and name. Layouts follow
the JAX package: trajectory tensors are channels-last (batch, *spacetime,
channels). Entry points run on the CUDA card unless the caller passes
``device="cpu"``; every hand-written kernel (``ops/``, sources in ``csrc/``)
keeps a plain-PyTorch version beside it that runs for CPU tensors only.
"""

__version__ = "0.1.0"

from safediffcon_torch.core.schedules import DiffusionSchedule, make_schedule
from safediffcon_torch.core.diffusion import GaussianDiffusion, DiffusionConfig

__all__ = [
    "DiffusionSchedule",
    "make_schedule",
    "GaussianDiffusion",
    "DiffusionConfig",
]
