from .kernel import grayscale_kernel
from .ops import grayscale, grayscale_oracle, grid_steps, vmem_bytes

__all__ = ["grayscale", "grayscale_oracle", "grayscale_kernel",
           "vmem_bytes", "grid_steps"]
