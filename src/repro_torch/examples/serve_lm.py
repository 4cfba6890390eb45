"""Batched serving example: requests through the slot-based engine, on
the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from . import _cli


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm",
        description=__doc__.split("\n")[0])
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    from ..launch.serve import run
    # hybrid arch through the same engine (API-uniform serving)
    run("zamba2-2.7b-smoke", requests=12, slots=4, prompt_len=24,
        max_new=12, device=args.device)
    run("qwen2-0.5b-smoke", requests=16, slots=8, prompt_len=32,
        max_new=16, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
