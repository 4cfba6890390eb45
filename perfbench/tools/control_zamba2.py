"""Readings that the limits of ``correct`` are set from, for a training
cell of Zamba2 in its published form, in one process on the card.

    python3 perfbench/tools/control_zamba2.py \
        --workload zamba2-2.7b.train-4k --seeds 11,12,...,18 \
        --control-seeds 11,12,13 [--per-leaf]

For every seed of ``--seeds`` the program's own reading, as a run takes
it: its first checked steps against the float32 reference
(``reference/zamba2_ref.py``).  For every seed of ``--control-seeds``
also the controls', each the reference with one fault put in the
program's place: ``fp8`` (float8 where the program holds bf16,
``ssm_ref.Precision``), ``scale_hd`` (the attention scaled by
1 / sqrt(hd) in place of the published 1 / sqrt(hd / 2)),
``no_embeddings`` (the shared blocks fed [h, 0] in place of [h, h0]),
and half of each batch left out.  Each reading is judged as a run
judges it, against the cell's limits.  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

CONTROLS = ("fp8", "scale_hd", "no_embeddings")


def _control(kind: str, arch):
    """(precision, variant) of the control ``kind``."""
    from perfbench.reference import zamba2_ref as Z
    if kind == "fp8":
        return Z.Precision("fp8"), Z.Variant()
    if kind == "scale_hd":
        return Z.Precision("f32"), Z.Variant(
            attn_scale=1.0 / math.sqrt(arch.head_dim))
    if kind == "no_embeddings":
        return Z.Precision("f32"), Z.Variant(embeddings_in=False)
    raise ValueError(kind)


def readings(name, seeds, control_seeds, device="cuda", emit=None,
             config_override=None, mix_override=None, per_leaf=False):
    import torch
    from perfbench import weights as W
    from perfbench.drivers import train as T
    from perfbench.drivers import train_zamba2 as TZ
    from perfbench.reference import zamba2_ref as Z
    from perfbench.tools.control import _ctx
    ctx = _ctx(name, device, config_override, mix_override)
    emit = emit or (lambda d: print(json.dumps(d), flush=True))
    TZ.check_extra_keys(ctx.config)
    arch = Z.Arch.from_json(ctx.config)
    spec = Z.param_spec(arch)

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
        ref = TZ.reference(ctx, arch, spec, Z.Precision("f32"))
        judged("program", got, ref)
        if seed in control_seeds:
            for kind in CONTROLS:
                prec, var = _control(kind, arch)
                ctl = TZ.reference(ctx, arch, spec, prec, var=var)
                judged("control_" + kind, ctl, ref)
            cut = TZ.reference(ctx, arch, spec, Z.Precision("f32"),
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
