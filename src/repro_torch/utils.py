"""Device selection and host-to-device conversion shared by the package.

Every entry point takes a ``device`` argument.  ``None`` means the CUDA
card: an entry point runs on the CPU only when the caller asks for it
(``device="cpu"``), and raises where CUDA is absent rather than
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["resolve_device", "from_numpy"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def from_numpy(arrays: Any, device=None) -> Any:
    """A numpy array, or a tuple or list of them (frames, GMM state), as
    tensors on ``device`` with their dtypes kept — so inputs made with
    numpy feed this package and another framework identically."""
    dev = resolve_device(device)
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(from_numpy(a, dev) for a in arrays)
    return torch.from_numpy(np.ascontiguousarray(arrays)).to(dev)
