from .kernel import hessian_kernel, steepest_descent_kernel
from .ops import (grid_steps, hessian, hessian_oracle, hessian_vmem_bytes,
                  steepest_descent, steepest_descent_oracle, vmem_bytes)

__all__ = ["steepest_descent", "steepest_descent_oracle",
           "hessian", "hessian_oracle", "steepest_descent_kernel",
           "hessian_kernel", "vmem_bytes", "grid_steps",
           "hessian_vmem_bytes"]
