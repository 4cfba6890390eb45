"""End-to-end example: train a ~90M-param qwen2-family LM for a few
hundred steps on the synthetic Markov stream, with async checkpoints and
watchdog, on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Optional, Sequence

from . import _cli

NAME = "qwen2-110m"


def qwen2_110m():
    """~90M params: the qwen2 family at d 768, 12 layers, a 4k vocab
    (kept small so the synthetic bigram table is learnable in O(100)
    steps), float32."""
    from ..configs import get_config
    return dataclasses.replace(
        get_config("qwen2-0.5b"), name=NAME, n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=4096, dtype="float32",
        param_dtype="float32")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm",
        description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--ckpt-dir", default=None)
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    from ..configs import registry
    from ..launch.train import run
    cfg = qwen2_110m()
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm")
    # the launcher takes an arch name: register the config for this run
    # only, so the registry lists the ten archs again afterwards
    registry.ARCHS[cfg.name] = cfg
    try:
        _, losses = run(cfg.name, steps=args.steps, batch=8, seq=128,
                        lr=6e-4, microbatches=1, remat="none",
                        ckpt_dir=ckpt, ckpt_every=100, device=args.device)
    finally:
        del registry.ARCHS[cfg.name]
    drop = losses[0] - losses[-1]
    print(f"loss drop over {args.steps} steps: {drop:.3f} "
          f"({'OK' if drop > 0.3 else 'check hyperparameters'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
