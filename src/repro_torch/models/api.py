"""Model factory + abstract input specs.

``build_model(cfg, device)`` returns the family implementation with its
parameters on ``device`` (the card unless the caller asks for the CPU);
the ``*_specs`` functions return ``device="meta"`` tensors for every
model input — shapes and dtypes with no storage, the port's counterpart
of the JAX package's ``ShapeDtypeStruct`` stand-ins.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..utils import resolve_device
from .blocks import torch_dtype
from .encdec import EncDecLM
from .hybrid import HybridLM
from .ssm_lm import MambaLM
from .transformer import DecoderLM
from .zamba2 import Zamba2LM

__all__ = ["build_model", "train_batch_specs", "prefill_specs",
           "decode_specs", "params_specs", "make_synthetic_batch"]

_FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "ssm": MambaLM,
             "hybrid": HybridLM, "encdec": EncDecLM, "zamba2": Zamba2LM}


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg.family`` on ``device`` (None: the card; "meta":
    shapes only), its parameters drawn from ``generator`` (seed 0 on the
    model's device when None)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    return _FAMILIES[cfg.family](cfg, device, generator)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def params_specs(cfg: ModelConfig):
    """The parameter tree as meta tensors."""
    return build_model(cfg, "meta").params()


def _batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.encoder_frames, cfg.d_model),
                                torch_dtype(cfg.dtype))
    if cfg.mrope:
        batch["mrope_positions"] = _meta((3, B, S), torch.int32)
    return batch


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch = _batch_specs(cfg, B, S)
    batch["targets"] = _meta((B, S), torch.int32)
    batch["mask"] = _meta((B, S), torch.float32)
    return batch


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    return _batch_specs(cfg, shape.global_batch, shape.seq_len)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Any, Any]:
    """(tokens, cache) specs for one decode step with a seq_len cache."""
    B, S = shape.global_batch, shape.seq_len
    cache = build_model(cfg, "meta").init_cache(B, S)
    return _meta((B, 1), torch.int32), cache


def make_synthetic_batch(cfg: ModelConfig, shape_or_bs, seq=None,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> Dict[str, torch.Tensor]:
    """Concrete random batch (for smoke tests / the example trainers),
    drawn from ``generator`` (seed 0 on ``device`` when None) on
    ``device`` (the card unless asked for the CPU)."""
    if isinstance(shape_or_bs, ShapeSpec):
        B, S = shape_or_bs.global_batch, shape_or_bs.seq_len
    else:
        B, S = shape_or_bs, seq
    dev = resolve_device(device)
    g = (generator if generator is not None
         else torch.Generator(device=dev).manual_seed(0))

    def randint(shape):
        return torch.randint(0, cfg.vocab, shape, generator=g, device=dev,
                             dtype=torch.int32)

    batch = {
        "tokens": randint((B, S)),
        "targets": randint((B, S)),
        "mask": torch.ones((B, S), dtype=torch.float32, device=dev),
    }
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (B, cfg.encoder_frames, cfg.d_model), generator=g, device=dev,
            dtype=torch.float32).to(torch_dtype(cfg.dtype))
    if cfg.mrope:
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        batch["mrope_positions"] = pos[None, None, :].expand(3, B, S)
    return batch
