"""Serving engine: batched prefill + decode loop + microbatcher.

``generate`` is the greedy/temperature sampler (prefill, then one
``decode_step`` per new token).  ``ServeEngine`` adds the host-side
layer a deployment needs: fixed-shape request slots (padded batching),
admission between decode bursts, and per-request length accounting.
Both operate purely through the model API (prefill / decode_step), so
every zoo family serves through the same engine.  Eager PyTorch: each
decode step launches the model's kernels one by one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["generate", "make_generate", "ServeEngine", "Request"]


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator) -> torch.Tensor:
    """Greedy argmax at temperature 0, else Gumbel-max sampling with
    noise from ``generator`` (not ``jax.random``'s bits: the JAX package
    and the port agree at temperature 0 only)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits / temperature + g, dim=-1)


def make_generate(model, *, max_new: int, temperature: float = 0.0
                  ) -> Callable[..., torch.Tensor]:
    """Build generate(batch, generator=None) -> (B, max_new) tokens."""

    @torch.no_grad()
    def _generate(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator(device=model.device).manual_seed(0)
        S = batch["tokens"].shape[1]
        logits, cache = model.prefill(batch, max_len=S + max_new)
        tok = _sample(logits, temperature, generator)
        toks = [tok]
        for _ in range(max_new - 1):
            logits, cache = model.decode_step(tok[:, None], cache)
            tok = _sample(logits, temperature, generator)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    return _generate


def generate(model, batch, *, max_new: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return make_generate(model, max_new=max_new,
                         temperature=temperature)(batch, generator)


# ----------------------------------------------------------------------
# Host-side batched serving
# ----------------------------------------------------------------------

@dataclass
class Request:
    rid: int
    prompt: np.ndarray                     # (S,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Padded-slot batched serving over the model API.

    Admissions happen between bursts: pending requests are left-padded
    with token 0 (no pad mask) to the slot shape, the batch is padded
    with zero prompts to ``slots``, prefilled as one batch, then decoded
    for ``max_new`` steps; each request keeps its first ``max_new`` of
    them.
    """

    def __init__(self, model, *, slots: int = 8, prompt_len: int = 64,
                 max_new: int = 32, temperature: float = 0.0):
        self.model = model
        self.slots = slots
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self._gen = make_generate(model, max_new=max_new,
                                  temperature=temperature)
        self._generator = torch.Generator(device=model.device).manual_seed(0)

    def submit(self, rid: int, prompt: np.ndarray,
               max_new: Optional[int] = None):
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new or self.max_new))

    def _pad(self, p: np.ndarray) -> np.ndarray:
        if len(p) >= self.prompt_len:
            return p[-self.prompt_len:]
        return np.pad(p, (self.prompt_len - len(p), 0))

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue; returns rid -> generated tokens."""
        results: Dict[int, List[int]] = {}
        while self.queue:
            burst = self.queue[: self.slots]
            self.queue = self.queue[self.slots:]
            prompts = np.stack([self._pad(r.prompt) for r in burst])
            if len(burst) < self.slots:   # pad batch to slot count
                fill = np.zeros((self.slots - len(burst), self.prompt_len),
                                np.int32)
                prompts = np.concatenate([prompts, fill])
            tokens = torch.from_numpy(prompts).to(self.model.device)
            toks = self._gen({"tokens": tokens}, self._generator)
            toks = toks.cpu().numpy()
            for i, r in enumerate(burst):
                r.out = toks[i, : r.max_new].tolist()
                r.done = True
                results[r.rid] = r.out
        return results
