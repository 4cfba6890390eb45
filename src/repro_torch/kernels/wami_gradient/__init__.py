from .kernel import gradient_kernel
from .ops import gradient, gradient_oracle, grid_steps, vmem_bytes
from .ref import gradient_ref

__all__ = ["gradient", "gradient_oracle", "gradient_ref", "gradient_kernel",
           "vmem_bytes", "grid_steps"]
