"""Training cells of Zamba2 in its published form: the training driver
(``drivers/train.py``: the program's step driven as its launcher drives
it, the checked first steps, the window, the traced steps) with
``reference/zamba2_ref.py`` in the place of ``ssm_ref``.

The configuration file's keys beyond the common ones (``EXTRA_KEYS``:
the norm epsilon, the adapters' rank, the shared blocks and their
sites) are held against the program's configuration as well, before any
weight is drawn.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import weights as W
from ..common import Context, program_config, sync, traced
from ..generators import GENERATORS
from ..reference import zamba2_ref
from .train import Program, _opt_fields, checked_steps, compare

EXTRA_KEYS = ("norm_eps", "adapter_rank", "num_mem_blocks",
              "hybrid_layer_ids")


def check_extra_keys(config: Dict) -> None:
    """Refuse a program whose configuration departs from the file's
    ``EXTRA_KEYS`` (a program without the configuration fails here)."""
    cfg = program_config(config)
    diff = {k: (getattr(cfg, k, None), config[k]) for k in EXTRA_KEYS
            if k in config and _plain(getattr(cfg, k, None)) != config[k]}
    if diff:
        raise SystemExit(f"the program's {config['arch']} departs from "
                         f"its configuration file: {diff}")


def _plain(v):
    return list(v) if isinstance(v, tuple) else v


def run(ctx: Context) -> None:
    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    check_extra_keys(ctx.config)
    # the program's allocator setting, which its model build makes too,
    # made before the weights are drawn on the card
    from repro_torch.models.zamba2 import grow_segments
    grow_segments(dev)
    arch = zamba2_ref.Arch.from_json(ctx.config)
    spec = zamba2_ref.param_spec(arch)

    prog = Program(ctx, W.draw(spec, seed, dev))
    # the first steps, through the window's own call and feed
    got = checked_steps(ctx, prog, spec)
    sync(dev)
    ctx.setup_s = time.perf_counter() - ctx.t_start

    # the window
    tokens = mix["batch"] * mix["seq_len"]
    steps: List = []
    k = int(mix["check_steps"])
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        ts = time.perf_counter()
        loss = prog.step(k)
        steps.append((ts, time.perf_counter(), loss))
        k += 1
    done = sum(1.0 if te <= end else (end - ts) / (te - ts)
               for ts, te, _ in steps)
    ctx.attempted = len(steps)
    ctx.failed = sum(1 for *_, loss in steps if loss != loss)
    ctx.records.update(
        window_s=ctx.seconds, steps_done=done, tokens_per_step=tokens,
        batch=mix["batch"], seq_len=mix["seq_len"])

    if ctx.trace:
        with traced(ctx):
            for _ in range(int(mix["trace_steps"])):
                prog.step(k)
                k += 1

    ctx.memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, from the same seed, over the same first batches
    t = time.perf_counter()
    ref = reference(ctx, arch, spec, zamba2_ref.Precision("f32"))
    ctx.records["reference_s"] = time.perf_counter() - t
    readings = compare(got, ref)
    ctx.records["readings"] = readings
    ctx.judge(readings)


def reference(ctx: Context, arch, spec, prec, fault=None,
              var: zamba2_ref.Variant = zamba2_ref.Variant()) -> Dict:
    """The reference's losses, first clipped gradient and each leaf's
    change over the mix's ``check_steps`` from the run's seed, on the same
    batches (each passed through ``fault`` first, when given), with the
    variant ``var`` of the model."""
    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    zamba2_ref.configure()
    gen = GENERATORS[mix["generator"]]
    cut = fault or (lambda a: a)
    batches = []
    for k in range(int(mix["check_steps"])):
        b = gen(mix, seed, k, ctx.config["vocab"])
        batches.append((torch.from_numpy(cut(b["tokens"])).to(dev),
                        torch.from_numpy(cut(b["targets"])).to(dev)))
    Wf = {k: v.float() for k, v in W.draw(spec, seed, dev).items()}
    o = mix["optimizer"]
    opt = zamba2_ref.AdamW(no_decay=o["no_decay"],
                           warmup_steps=o["warmup_steps"],
                           total_steps=o["total_steps"], **_opt_fields(mix))
    out = zamba2_ref.train_steps(arch, Wf, {k: s[1] for k, s in spec.items()},
                                 batches, opt, prec,
                                 rows_per_block=int(mix["reference_rows"]),
                                 var=var)
    change = {}
    for path in spec:
        p0 = W.draw_one(spec, seed, path, dev).float()
        change[path] = float((Wf[path] - p0).norm())
    out["change"] = change
    del Wf
    return out
