"""The Mamba2 SSD chunked scan: the hand-written CUDA kernels
(``csrc/ssd_scan.cu``, the forward; ``csrc/ssd_scan_bwd.cu``, its
backward), the model's differentiable call on the card (``grad.py``),
and the plain PyTorch versions (the sequential recurrence, the chunked
passes and their gradient)."""
from .grad import pad_to_chunks, ssd_train
from .kernel import (SsdGradPlan, SsdPlan, ssd_bwd_scratch_floats,
                     ssd_bwd_smem_bytes, ssd_fwd_launch, ssd_grad_plan,
                     ssd_heads_per_cta, ssd_p_split, ssd_plan,
                     ssd_scan_bwd_cuda, ssd_scan_bwd_kernel, ssd_scan_cuda,
                     ssd_scan_kernel, ssd_scratch_floats, ssd_smem_bytes)
from .ops import ssd, ssd_chunk, ssd_oracle
from .ref import ssd_chunked_bwd_ref, ssd_chunked_ref, ssd_ref

__all__ = ["ssd", "ssd_oracle", "ssd_ref", "ssd_chunked_ref",
           "ssd_chunked_bwd_ref", "ssd_chunk", "ssd_scan_cuda",
           "ssd_scan_kernel", "ssd_smem_bytes", "ssd_heads_per_cta",
           "ssd_p_split", "ssd_scratch_floats", "ssd_plan", "SsdPlan",
           "ssd_scan_bwd_kernel", "ssd_bwd_smem_bytes",
           "ssd_bwd_scratch_floats", "ssd_grad_plan", "SsdGradPlan",
           "ssd_fwd_launch", "ssd_scan_bwd_cuda", "ssd_train",
           "pad_to_chunks"]
