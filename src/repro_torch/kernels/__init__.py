"""Hand-written CUDA kernels, with their plain PyTorch versions.

Each package holds ``ref.py`` (the plain version; ``causal_conv``'s is
the model's own ``models/ssm.py::_causal_conv``) and ``kernel.py`` (the
ctypes binding of its ``csrc/*.cu`` source with the launch count, and
its cost or staging model), and one of two wrappers:

  * ``ops.py`` (the kernel on a CUDA tensor, the plain version on a CPU
    tensor) in the WAMI stages' packages, seven kernels in six:
    ``wami_debayer``, ``wami_grayscale``, ``wami_gradient``,
    ``wami_steep`` (steepest descent and the Hessian), ``wami_warp`` and
    ``wami_change_det``; and in the fleet app's: ``flash_attention``
    (streaming-softmax attention on the model layout) and ``ssd_scan``
    (the Mamba2 SSD chunked scan);
  * ``grad.py`` (the LM path's differentiable call on the card, forward
    and backward in one ``autograd.Function``) in ``ssd_scan`` (beside
    its ``ops.py``), ``mamba_gate_norm`` (the Mamba2 mixer's epilogue)
    and ``causal_conv`` (the mixer's depthwise causal conv).

``route.py`` says where the LM path's calls run, kernel or plain
version, and counts each choice.  ``build.py`` compiles every source on
first use.
"""
