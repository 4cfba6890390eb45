from .kernel import warp_kernel
from .ops import grid_steps, vmem_bytes, warp_affine, warp_affine_oracle
from .ref import warp_affine_ref

__all__ = ["warp_affine", "warp_affine_oracle", "warp_affine_ref",
           "warp_kernel", "vmem_bytes", "grid_steps"]
