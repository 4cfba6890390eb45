"""Hand-written CUDA kernels of the WAMI stages, with their plain
PyTorch versions.

Each package ``wami_<stage>/`` holds ``ref.py`` (the plain version),
``kernel.py`` (the ctypes binding of ``csrc/wami_<stage>.cu`` with its
launch count and cost models) and ``ops.py`` (the wrapper: the kernel on
a CUDA tensor, the plain version on a CPU tensor).  Seven kernels in
five packages: ``wami_debayer``, ``wami_grayscale``, ``wami_gradient``,
``wami_steep`` (steepest descent and the Hessian), ``wami_warp`` and
``wami_change_det``.
"""
