"""Serving launcher: batched engine over any zoo arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --requests 16 --prompt-len 32 --max-new 16

Runs on the CUDA card unless ``--device cpu`` asks for the CPU; the
weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..data import SyntheticLM
from ..models import build_model
from ..serve import ServeEngine
from ..utils import resolve_device


def run(arch: str, *, requests: int = 16, slots: int = 8,
        prompt_len: int = 32, max_new: int = 16, temperature: float = 0.0,
        seed: int = 0, device=None):
    cfg = get_config(arch)
    dev = resolve_device(device)
    model = build_model(cfg, dev,
                        torch.Generator(device=dev).manual_seed(seed))
    src = SyntheticLM(vocab=cfg.vocab, seed=seed)
    prompts = src.batch(step=0, shard=0, n_shards=1, batch=requests,
                        seq=prompt_len)["tokens"]

    eng = ServeEngine(model, slots=slots, prompt_len=prompt_len,
                      max_new=max_new, temperature=temperature)
    for rid in range(requests):
        eng.submit(rid, prompts[rid])
    t0 = time.perf_counter()
    results = eng.run()
    wall = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    print(f"[serve] {cfg.name} on {dev}: {requests} requests x {max_new} "
          f"tokens in {wall:.2f}s = {toks / wall:.1f} tok/s "
          f"(slots={slots}, greedy={temperature <= 0})")
    print(f"[serve] sample output (rid 0): {results[0][:12]}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    run(a.arch, requests=a.requests, slots=a.slots, prompt_len=a.prompt_len,
        max_new=a.max_new, temperature=a.temperature, seed=a.seed,
        device=a.device)


if __name__ == "__main__":
    main()
