"""The paper's experiment in one command: COSMOS DSE of the WAMI
accelerator — Table 1 spans, Fig. 10 Pareto curve, Fig. 11 invocations —
plus a functional run of the accelerator itself (Lucas-Kanade alignment
+ change detection on synthetic frames, on the card unless ``--device
cpu``).

The DSE runs through the batched ``ExplorationSession`` API: all 12
components characterize concurrently, all plan points map concurrently,
and the results (fronts AND invocation counts) are identical to the
sequential drive.

    PYTHONPATH=src python -m repro_torch.examples.wami_dse --device cpu
"""

from __future__ import annotations

import argparse
import statistics
from typing import Optional, Sequence

import numpy as np
import torch

from . import _cli


def synthetic_frames(device=None) -> torch.Tensor:
    """Three 64 x 64 frames: a smoothed random scene (a 5 x 5 box filter
    over uniform noise from ``numpy.random.default_rng(0)``, times 100),
    the same again, and the scene with an 8 x 8 block brightened by 180
    at rows and columns 20-27."""
    from ..utils import from_numpy
    noise = from_numpy(np.random.default_rng(0).uniform(
        size=(1, 1, 64, 64)).astype(np.float32), device)
    base = torch.nn.functional.conv2d(
        noise, torch.full((1, 1, 5, 5), 1 / 25, device=noise.device),
        padding=2)[0, 0] * 100
    moving = base.clone()
    moving[20:28, 20:28] += 180.0
    return torch.stack([base, base, moving])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.wami_dse",
        description=__doc__.split("\n")[0])
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    from ..apps.wami import (WAMI_KNOB_TABLE, wami_app, wami_exhaustive,
                             wami_session)
    from ..apps.wami.pipeline import wami_cosmos_no_memory

    # ---- the accelerator actually runs ---------------------------------
    masks, _ = wami_app(synthetic_frames(args.device), n_iters=4,
                        device=args.device)
    inside = float(masks[1][20:28, 20:28].float().mean())
    print(f"[wami] change-detection foreground on moved frame: "
          f"{inside:.0%} inside, {float(masks[1].float().mean()):.1%} "
          f"overall")

    # ---- the paper's DSE, batched through ExplorationSession -----------
    def on_event(e):
        if e.done in (0, e.total):
            print(f"[session] {e.phase:12s} {e.done}/{e.total} {e.label}")

    session = wami_session(delta=0.25, workers=8, on_event=on_event)
    cos = session.run()
    nm = wami_cosmos_no_memory(delta=0.25)
    exh = wami_exhaustive(workers=8)

    lam = statistics.mean(c.lam_span for c in cos.characterizations.values())
    lam_nm = statistics.mean(c.lam_span for c in nm.characterizations.values())
    area = statistics.mean(c.area_span for c in cos.characterizations.values())
    area_nm = statistics.mean(c.area_span
                              for c in nm.characterizations.values())
    print(f"[table1] knob table: "
          f"{', '.join(f'{n}={p}p/{u}u' for n, (p, u) in WAMI_KNOB_TABLE.items())}")
    print(f"[table1] spans with memory co-design: lambda {lam:.2f}x, "
          f"area {area:.2f}x   (paper: 4.06x / 2.58x)")
    print(f"[table1] spans dual-port only:        lambda {lam_nm:.2f}x, "
          f"area {area_nm:.2f}x   (paper: 1.73x / 1.22x)")

    red = exh.total_invocations / cos.total_invocations
    per = max(exh.invocations[n] / max(1, cos.invocations.get(n, 1))
              for n in exh.invocations)
    by_phase = session.ledger.records_by_phase()
    print(f"[fig11] invocations: exhaustive {exh.total_invocations} vs "
          f"COSMOS {cos.total_invocations} = {red:.1f}x avg, "
          f"up to {per:.1f}x   (paper: 6.7x avg, up to 14.6x)")
    print("[fig11] COSMOS breakdown by phase: "
          + ", ".join(f"{k}={v}" for k, v in by_phase.items()))

    print(f"[fig10] Pareto curve ({len(cos.mapped)} points, "
          f"theta in [{cos.theta_min:.1f}, {cos.theta_max:.1f}] frames/s):")
    for m in cos.mapped:
        print(f"   theta {m.theta_actual:7.1f} fps  area "
              f"{m.cost_actual:6.2f} mm^2  sigma {m.sigma_mismatch:6.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
