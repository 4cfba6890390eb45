"""Quickstart: build a zoo model, train a few steps, generate — then run
a tiny COSMOS exploration through the batched ExplorationSession API.
The model runs on the CUDA card unless ``--device cpu``; its weights are
random, drawn from seed 0.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from . import _cli


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description=__doc__.split("\n")[0])
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    from ..configs import get_config, list_archs
    from ..data import SyntheticLM
    from ..models import build_model
    from ..optim import AdamWConfig, init_opt
    from ..serve import generate
    from ..train import TrainStepConfig, make_train_step
    from ..utils import resolve_device

    print("available archs:", ", ".join(list_archs()))
    dev = resolve_device(args.device)
    cfg = get_config("gemma2-9b").reduced()     # same family, CPU-sized
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    params = model.params()

    step = make_train_step(model, AdamWConfig(lr=1e-3),
                           TrainStepConfig(remat="none", total_steps=30))
    opt = init_opt(params)
    src = SyntheticLM(vocab=cfg.vocab, seed=0)
    for i in range(30):
        b = src.batch(step=i, shard=0, n_shards=1, batch=8, seq=64)
        params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(dev)
                                            for k, v in b.items()})
        if i % 10 == 0:
            print(f"step {i:3d} loss {float(m['loss']):.4f}")

    prompt = torch.from_numpy(b["tokens"][:2, :16]).to(dev)
    out = generate(model, {"tokens": prompt}, max_new=12)
    print("generated:", out.tolist()[0])

    # ---- a 30-second COSMOS exploration (the paper's engine) ----------
    from ..core import (ExplorationSession, HLSTool, KnobSpace,
                        pipeline_tmg)
    from ..core.hlsim import ComponentSpec, LoopNest
    specs = {
        "stage_a": ComponentSpec("stage_a",
                                 LoopNest(256, 2, 1, 8, 3, 6), 1024, 1024),
        "stage_b": ComponentSpec("stage_b",
                                 LoopNest(128, 1, 1, 4, 2, 4), 512, 512),
    }
    session = ExplorationSession(
        pipeline_tmg(list(specs), buffers=2), HLSTool(specs),
        {n: KnobSpace(clock_ns=1.0, max_ports=4, max_unrolls=8)
         for n in specs},
        delta=0.3, workers=4)
    res = session.run()
    print(f"cosmos: {len(res.mapped)} mapped points from "
          f"{res.total_invocations} oracle invocations "
          f"(theta in [{res.theta_min:.0f}, {res.theta_max:.0f}] runs/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
