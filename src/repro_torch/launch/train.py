"""Training launcher: data pipeline + step + checkpoints + fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 40 --batch 16 --seq 128 --ckpt-dir build/run1

Runs on the CUDA card unless ``--device cpu`` asks for the CPU; the
weights are random, drawn from ``--seed``.  Any ``--arch`` accepts the
``-smoke`` suffix for the reduced config.  Restarts resume from the
newest atomic checkpoint, replaying the data stream from the recorded
step.  The step is eager PyTorch; each step's loss is read on the host
(one sync a step), as the JAX package's launcher reads it.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs import get_config
from ..data import DataPipeline, SyntheticLM
from ..ft import Watchdog
from ..models import build_model
from ..optim import AdamWConfig, init_opt
from ..train import TrainStepConfig, make_train_step
from ..utils import resolve_device, tree_leaves


def run(arch: str, *, steps: int = 100, batch: int = 16, seq: int = 128,
        lr: float = 3e-4, microbatches: int = 1, remat: str = "none",
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        log_every: int = 10, seed: int = 0, watchdog_timeout: float = 600.0,
        device=None):
    """Train ``arch`` for ``steps`` steps; returns ``(params, losses)``
    (the model's parameter tree and each step's loss run here)."""
    cfg = get_config(arch)
    dev = resolve_device(device)
    model = build_model(cfg, dev,
                        torch.Generator(device=dev).manual_seed(seed))
    params = model.params()
    opt = init_opt(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{steps} steps, batch {batch} x seq {seq}")

    step_fn = make_train_step(
        model, AdamWConfig(lr=lr),
        TrainStepConfig(microbatches=microbatches, remat=remat,
                        warmup_steps=max(1, steps // 20), total_steps=steps))

    start = 0
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and (resume := latest_step(ckpt_dir)) is not None:
        state, extra = restore(ckpt_dir, resume,
                               {"params": params, "opt": opt})
        with torch.no_grad():
            for p, saved in zip(tree_leaves(params),
                                tree_leaves(state["params"])):
                p.copy_(saved)
        opt = state["opt"]
        del state
        start = extra.get("data_step", resume)
        print(f"[train] resumed from step {start}")

    src = SyntheticLM(vocab=cfg.vocab, seed=seed)
    pipe = DataPipeline(src, global_batch=batch, seq=seq, start_step=start)
    wd = Watchdog(timeout_s=watchdog_timeout,
                  on_stall=lambda s, gap: print(
                      f"[watchdog] STALL at step {s} ({gap:.0f}s) — "
                      f"restart from {ckpt_dir or 'nowhere (no ckpt dir!)'}"))

    losses = []
    t0 = time.time()
    try:
        for i in range(start, steps):
            b = next(pipe)
            tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            params, opt, metrics = step_fn(params, opt, tb)
            wd.beat(i)
            losses.append(float(metrics["loss"]))
            if (i + 1) % log_every == 0:
                dt = (time.time() - t0) / max(1, len(losses))
                print(f"  step {i + 1:5d}  loss {losses[-1]:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  "
                      f"{dt * 1e3:.0f} ms/step")
            if ckpt and (i + 1) % ckpt_every == 0:
                ckpt.save_async(i + 1, {"params": params, "opt": opt},
                                extra={"data_step": i + 1})
    finally:
        pipe.close()
        wd.close()
        if ckpt:
            ckpt.wait()
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    run(a.arch, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr,
        microbatches=a.microbatches, remat=a.remat, ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every, seed=a.seed, device=a.device)


if __name__ == "__main__":
    main()
