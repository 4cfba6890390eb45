"""The paper's experiment scripts: the counterpart of the JAX package's
top-level ``benchmarks/``, one module per bench.

    PYTHONPATH=src python -m repro_torch.bench.run --list
    PYTHONPATH=src python -m repro_torch.bench.run --device cpu
    PYTHONPATH=src python -m repro_torch.bench.run --cell fig11/wami-analytical

Each executed cell writes ``artifacts/bench_torch/<bench>/<app>-<backend>
[-variant].csv`` beside a ``matrix.json`` summary (:mod:`.run`); the
matrix is enumerated from the port's registry (:mod:`.scenarios`).  The
measured backend is ``cuda``: its cells replay the card's recordings
under ``artifacts/measurements/``, and the kernels bench's ``cuda`` cells
launch every registered kernel on the card against its plain version.
"""
