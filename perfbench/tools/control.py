"""Readings that the limits of ``correct`` are set from, for one training
cell, in one process on the card.

    python3 perfbench/tools/control.py --workload mamba2-780m.train-2k \
        --seeds 11,12,...,22 --control-seeds 11,12,13 [--per-leaf]

For every seed of ``--seeds`` the program's own reading, as a run takes
it: its first checked steps against the float32 reference.  For every
seed of ``--control-seeds`` also the controls', the reference put in the
program's place one step of precision down (``ssm_ref.Precision``:
``fp8``, float8 where the program holds bf16; ``bf16ssd``, the SSD in
bf16 where the program runs it in float32), and the fault of half the
batch left out.  Each reading is judged as a run judges it, against the
cell's limits (``Context.judge`` and ``Context.correct``).  One JSON line
a reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

CONTROLS = ("fp8", "bf16ssd")


def _ctx(name: str, device: str, config_override=None, mix_override=None):
    import torch
    from perfbench.common import Context, load_json
    from perfbench.run import find_cell
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(bench, name)
    pb = os.path.join(ROOT, "perfbench")
    config = load_json(os.path.join(pb, "configs", cell["config"] + ".json"))
    mix = load_json(os.path.join(pb, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(pb, "limits", name + ".json"))
    if config_override:
        config = config_override(config)
    if mix_override:
        mix = mix_override(mix)
    return Context(cell=cell, config=config, mix=mix, limits=limits, seed=0,
                   seconds=0.0, trace=False, device=torch.device(device),
                   t_start=time.perf_counter())


def readings(name, seeds, control_seeds, device="cuda", emit=None,
             config_override=None, mix_override=None, per_leaf=False):
    import torch
    from perfbench import weights as W
    from perfbench.drivers import train as T
    from perfbench.reference import ssm_ref
    ctx = _ctx(name, device, config_override, mix_override)
    emit = emit or (lambda d: print(json.dumps(d), flush=True))
    arch = ssm_ref.Arch.from_json(ctx.config)
    spec = ssm_ref.param_spec(arch)

    def judged(side, got, ref):
        r = T.compare(got, ref)
        ctx.judge(r)
        out = {"seed": ctx.seed, "side": side, **r, "correct": ctx.correct()}
        if per_leaf:
            out["leaves"] = {
                "grad": T.leaf_gaps(got["first_grad"], ref["first_grad"]),
                "change": T.leaf_gaps(got["change"], ref["change"])}
        emit(out)

    for seed in seeds:
        ctx.seed = seed
        prog = T.Program(ctx, W.draw(spec, seed, ctx.device))
        got = T.checked_steps(ctx, prog, spec)
        del prog
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = T.reference(ctx, arch, spec, ssm_ref.Precision("f32"))
        judged("program", got, ref)
        if seed in control_seeds:
            for kind in CONTROLS:
                ctl = T.reference(ctx, arch, spec, ssm_ref.Precision(kind))
                judged("control_" + kind, ctl, ref)
            cut = T.reference(ctx, arch, spec, ssm_ref.Precision("f32"),
                              fault=T.half)
            judged("fault_half_batch", cut, ref)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--per-leaf", action="store_true",
                    help="each leaf's gaps as well")
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    readings(a.workload, seeds, ctl, per_leaf=a.per_leaf)


if __name__ == "__main__":
    main()
