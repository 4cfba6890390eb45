"""The Mamba2 mixer's epilogue (D skip, SiLU gate, gated RMSNorm): the
hand-written CUDA kernels (``csrc/mamba_gate_norm.cu``, forward and
backward), the model's differentiable call on the card (``grad.py``),
and the plain versions of both (``ref.py``)."""
from .grad import gate_norm
from .kernel import (gate_norm_aligned, gate_norm_bwd_cuda,
                     gate_norm_bwd_kernel, gate_norm_bwd_scratch_floats,
                     gate_norm_fwd_cuda, gate_norm_kernel, gate_norm_operand)
from .ref import gate_norm_bwd_ref, gate_norm_ref

__all__ = ["gate_norm", "gate_norm_kernel",
           "gate_norm_bwd_kernel", "gate_norm_fwd_cuda",
           "gate_norm_bwd_cuda", "gate_norm_bwd_scratch_floats",
           "gate_norm_operand", "gate_norm_aligned",
           "gate_norm_ref", "gate_norm_bwd_ref"]
