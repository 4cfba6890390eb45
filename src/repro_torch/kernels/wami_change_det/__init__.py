from .kernel import change_det_kernel
from .ops import (change_detection, change_detection_oracle, grid_steps,
                  vmem_bytes)
from .ref import change_detection_ref

__all__ = ["change_detection", "change_detection_oracle",
           "change_detection_ref", "change_det_kernel", "vmem_bytes",
           "grid_steps"]
