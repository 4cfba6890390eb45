"""Training cells: the program's train step driven as its launcher drives
it (batch to the card, the step, the loss read back), over the
mix's rows, for a fixed window.

Set-up builds one step with its model and optimizer state and runs the
mix's ``check_steps`` first steps through the same call and feed as the
window; their losses, the first clipped gradient (read back from the
optimizer's first moment) and each leaf's change after them are what
the reference is held to, once the window has closed and the program's
state is freed.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from .. import weights as W
from ..common import Context, load_params, program_config, sync, traced
from ..generators import GENERATORS
from ..reference import ssm_ref


def _opt_fields(mix: Dict) -> Dict:
    o = mix["optimizer"]
    return {k: o[k] for k in ("lr", "b1", "b2", "eps", "weight_decay",
                              "clip_norm")}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between two per-leaf norms, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


class Program:
    """The program's model, optimizer state and step, fed by the mix."""

    def __init__(self, ctx: Context, weights: Dict[str, torch.Tensor]):
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig, init_opt
        from repro_torch.train import TrainStepConfig, make_train_step
        mix, dev = ctx.mix, ctx.device
        self.ctx = ctx
        self.cfg = program_config(ctx.config)
        self.model = build_model(self.cfg, dev)
        load_params(self.model, weights)
        self.params = self.model.params()
        self.opt = init_opt(self.params)
        o = mix["optimizer"]
        self.step_fn = make_train_step(
            self.model, AdamWConfig(**_opt_fields(mix)),
            TrainStepConfig(remat=mix["remat"],
                            warmup_steps=o["warmup_steps"],
                            total_steps=o["total_steps"]))
        self.gen = GENERATORS[mix["generator"]]

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        mix, dev = self.ctx.mix, self.ctx.device
        b = self.gen(mix, self.ctx.seed, k, self.ctx.config["vocab"])
        out = {n: torch.from_numpy(v).to(dev) for n, v in b.items()}
        out["mask"] = torch.ones(out["tokens"].shape, dtype=torch.float32,
                                 device=dev)
        return out

    def step(self, k: int) -> float:
        self.params, self.opt, m = self.step_fn(self.params, self.opt,
                                                self.batch(k))
        return float(m["loss"])

    def leaves(self, tree) -> Dict[str, torch.Tensor]:
        from repro_torch.utils import leaves_with_paths
        return dict(leaves_with_paths(tree))


def checked_steps(ctx: Context, prog: Program, spec) -> Dict:
    """Run the program's first ``check_steps`` steps; return their losses,
    the first clipped gradient's norm per leaf (from the optimizer's first
    moment after one step) and each leaf's change after them."""
    b1 = ctx.mix["optimizer"]["b1"]
    losses = [prog.step(0)]
    first_grad = {k: float(m.float().norm()) / (1 - b1)
                  for k, m in prog.leaves(prog.opt.mu).items()}
    losses += [prog.step(k) for k in range(1, int(ctx.mix["check_steps"]))]
    change = {}
    with torch.no_grad():
        for path, p in prog.leaves(prog.params).items():
            p0 = W.draw_one(spec, ctx.seed, path, ctx.device)
            change[path] = float((p.float() - p0.float()).norm())
            del p0
    return {"losses": losses, "first_grad": first_grad, "change": change}


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers a cell's limits may hold: the largest relative gap of
    a step's loss, the worst leaf's gap of the first clipped gradient's
    norm (and the median leaf's, and each leaf's as
    ``grad_gap[<path>]``) and of the change's norm.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move
    by round-off alone and are left out of the change."""
    med = statistics.median(ref["first_grad"].values())
    keep = {k for k, g in ref["first_grad"].items() if g >= 1e-3 * med}
    grad = leaf_gaps(got["first_grad"], ref["first_grad"])
    change = leaf_gaps(got["change"], ref["change"], keep)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": statistics.median(grad.values()),
        **{f"grad_gap[{k}]": v for k, v in grad.items()},
    }


def run(ctx: Context) -> None:
    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    arch = ssm_ref.Arch.from_json(ctx.config)
    spec = ssm_ref.param_spec(arch)

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
    while True:
        ts = time.perf_counter()
        if ts >= end:
            break
        loss = prog.step(k)
        te = time.perf_counter()
        steps.append((ts, te, loss))
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
    ref = reference(ctx, arch, spec, ssm_ref.Precision("f32"))
    ctx.records["reference_s"] = time.perf_counter() - t
    readings = compare(got, ref)
    ctx.records["readings"] = readings
    ctx.judge(readings)


def half(a):
    """Half of a batch: its first rows, or of one row its first tokens."""
    return a[: len(a) // 2] if len(a) > 1 else a[:, : a.shape[1] // 2]


def reference(ctx: Context, arch, spec, prec, fault=None) -> Dict:
    """The reference's losses, first clipped gradient and each leaf's
    change over the mix's ``check_steps`` from the run's seed, on the same
    batches (each passed through ``fault`` first, when given)."""
    mix, dev, seed = ctx.mix, ctx.device, ctx.seed
    ssm_ref.configure()
    gen = GENERATORS[mix["generator"]]
    cut = fault or (lambda a: a)
    batches = []
    for k in range(int(mix["check_steps"])):
        b = gen(mix, seed, k, ctx.config["vocab"])
        batches.append((torch.from_numpy(cut(b["tokens"])).to(dev),
                        torch.from_numpy(cut(b["targets"])).to(dev)))
    Wf = {k: v.float() for k, v in W.draw(spec, seed, dev).items()}
    o = mix["optimizer"]
    opt = ssm_ref.AdamW(no_decay=o["no_decay"],
                        warmup_steps=o["warmup_steps"],
                        total_steps=o["total_steps"], **_opt_fields(mix))
    out = ssm_ref.train_steps(arch, Wf, {k: s[1] for k, s in spec.items()},
                              batches, opt, prec,
                              rows_per_block=int(mix["reference_rows"]))
    change = {}
    for path in spec:
        p0 = W.draw_one(spec, seed, path, dev).float()
        change[path] = float((Wf[path] - p0).norm())
    out["change"] = change
    del Wf
    return out
