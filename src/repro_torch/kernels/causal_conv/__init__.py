"""The Mamba2 mixer's depthwise causal conv (with its bias and SiLU): the
hand-written CUDA kernels (``csrc/mamba_causal_conv.cu``, forward and
backward) and the model's differentiable call on the card
(``grad.py``).  The plain version is the model's own
``models/ssm.py::_causal_conv``, which the kernels are held against."""
from .grad import causal_conv, conv_new_state
from .kernel import (MAX_TAPS, causal_conv_bwd_cuda, causal_conv_bwd_kernel,
                     causal_conv_bwd_scratch_floats, causal_conv_fwd_cuda,
                     causal_conv_kernel, conv_operand)

__all__ = ["causal_conv", "conv_new_state", "causal_conv_kernel",
           "causal_conv_bwd_kernel", "causal_conv_fwd_cuda",
           "causal_conv_bwd_cuda", "causal_conv_bwd_scratch_floats",
           "conv_operand", "MAX_TAPS"]
