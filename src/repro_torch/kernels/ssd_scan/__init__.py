"""The Mamba2 SSD chunked scan: the hand-written CUDA kernel
(``csrc/ssd_scan.cu``) and its plain PyTorch version (the sequential
recurrence)."""
from .kernel import (SsdPlan, ssd_heads_per_cta, ssd_p_split, ssd_plan,
                     ssd_scan_cuda, ssd_scan_kernel, ssd_scratch_floats,
                     ssd_smem_bytes)
from .ops import ssd, ssd_chunk, ssd_oracle
from .ref import ssd_chunked_ref, ssd_ref

__all__ = ["ssd", "ssd_oracle", "ssd_ref", "ssd_chunked_ref", "ssd_chunk",
           "ssd_scan_cuda", "ssd_scan_kernel", "ssd_smem_bytes",
           "ssd_heads_per_cta", "ssd_p_split", "ssd_scratch_floats",
           "ssd_plan", "SsdPlan"]
