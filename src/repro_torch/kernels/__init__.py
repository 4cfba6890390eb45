"""Hand-written CUDA kernels, with their plain PyTorch versions.

Each package holds ``ref.py`` (the plain version), ``kernel.py`` (the
ctypes binding of its ``csrc/*.cu`` source with the launch count, and
its cost or staging model) and ``ops.py`` (the wrapper: the kernel on a
CUDA tensor, the plain version on a CPU tensor).

  * the WAMI stages, seven kernels in six packages: ``wami_debayer``,
    ``wami_grayscale``, ``wami_gradient``, ``wami_steep`` (steepest
    descent and the Hessian), ``wami_warp`` and ``wami_change_det``;
  * the fleet app: ``flash_attention`` (streaming-softmax attention on
    the model layout) and ``ssd_scan`` (the Mamba2 SSD chunked scan);
  * the LM path: ``mamba_gate_norm`` (the Mamba2 mixer's epilogue,
    forward and backward; ``ref.py``, ``kernel.py`` and ``grad.py``, the
    model's differentiable call).

``build.py`` compiles every source on first use.
"""
