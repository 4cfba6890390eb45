from .kernel import debayer_kernel
from .ops import debayer, debayer_oracle, grid_steps, vmem_bytes
from .ref import debayer_ref

__all__ = ["debayer", "debayer_oracle", "debayer_ref", "debayer_kernel",
           "vmem_bytes", "grid_steps"]
