"""The package's front doors, one module per script of the JAX
package's ``examples/`` (``wami_pallas`` becomes :mod:`.wami_cuda`; the
fleet's recorder, a part of that package's fleet bench there, is
:mod:`.fleet_cuda`).  Each runs as ``python -m
repro_torch.examples.<name>``, on the CUDA card unless ``--device cpu``
asks for the CPU, and prints the lines its counterpart prints.

The measured backend's record/replay workflow:

    python -m repro_torch.examples.wami_cuda --record --tile 128  # card
    python -m repro_torch.examples.fleet_cuda --record            # card
    python -m repro_torch.examples.wami_cuda --device cpu         # replay
    python -m repro_torch.examples.wami_plm --device cpu          # replay
"""
