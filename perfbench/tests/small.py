"""Reduced cells for the CPU: the program's ``.reduced()`` configuration
of the architecture and a few short rows."""

from repro_torch.configs import get_config

from perfbench.common import MODEL_KEYS


def small_config(cfg):
    c = get_config(cfg["arch"] + "-smoke")
    out = dict(cfg, arch=cfg["arch"] + "-smoke")
    for k in MODEL_KEYS:
        out[k] = getattr(c, k)
    return out


def small_mix(mix):
    return dict(mix, batch=2, seq_len=64, reference_rows=1, trace_steps=1)
