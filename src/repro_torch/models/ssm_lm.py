"""Mamba2 language model (attention-free, SSD blocks)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.sharding import constrain_residual
from ..train.remat import maybe_remat
from .blocks import (LMModule, Params, _dense_init, apply_norm,
                     embed_lookup, init_norm, masked_ce, stack_spec,
                     unstack_layers)
from .ssm import init_mamba, init_ssm_state, mamba_sequence, mamba_step

__all__ = ["MambaLM", "layer_state", "store_states"]


def layer_state(cache: Dict[str, Any], *idx: int) -> Dict[str, torch.Tensor]:
    """One layer's SSM and conv states of a stacked cache (views); an SSM
    state of None (a fresh start: the SSD takes no incoming state) stays
    None."""
    ssm = cache["ssm"]
    return {"ssm": None if ssm is None else ssm[idx],
            "conv": cache["conv"][idx]}


def store_states(cache: Dict[str, Any], idx, states: Dict[str, torch.Tensor]
                 ) -> None:
    """Write one layer's SSM and conv states into the cache at ``idx``."""
    cache["ssm"][idx].copy_(states["ssm"])
    cache["conv"][idx].copy_(states["conv"])


class MambaLM(LMModule):
    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.family != "ssm":
            raise ValueError(cfg.family)
        super().__init__(cfg, device, generator)

    # ------------------------------------------------------------------
    def _param_spec(self) -> Params:
        cfg, dt = self.cfg, self.dtype
        layer = {"ln": init_norm(cfg, dt), "mamba": init_mamba(cfg, dt)}
        params: Params = {
            "embed": _dense_init((cfg.vocab, cfg.d_model), dt),
            "final_norm": init_norm(cfg, dt),
            "layers": stack_spec(layer, (cfg.n_layers,)),
        }
        if not cfg.tie_embeddings:
            params["head"] = _dense_init((cfg.d_model, cfg.vocab), dt)
        return params

    def _forward(self, params, x, states
                 ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """All layers from ``states`` (stacked on L); returns the hidden
        states and each layer's new state."""
        cfg = self.cfg

        def one_layer(lp, x, st):
            h = apply_norm(lp["ln"], x, cfg.norm_kind)
            y, st_new = mamba_sequence(lp["mamba"], cfg, h, st)
            return x + y, st_new

        one_layer = maybe_remat(one_layer)
        new_states = []
        layers = unstack_layers(params["layers"])
        for i in range(cfg.n_layers):
            x = constrain_residual(x)
            x, st_new = one_layer(layers[i], x,
                                  layer_state(states, i))
            new_states.append(st_new)
        return x, new_states

    # ------------------------------------------------------------------
    def loss(self, batch) -> Tuple[torch.Tensor, Dict]:
        params = self.params()
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        h, _ = self._forward(params, x,
                             self._stacked_states(tokens.shape[0], ssm=False))
        ce = masked_ce(self._logits(params, h), targets, mask)
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    def _stacked_states(self, batch: int, ssm: bool = True):
        """Zero states of every layer; without ``ssm``, the SSM state is
        None (a fresh start, which the SSD takes as no incoming state)."""
        cfg = self.cfg
        one = init_ssm_state(cfg, batch, self.dtype, self.device)
        st = {k: a.new_zeros((cfg.n_layers,) + a.shape)
              for k, a in one.items() if ssm or k != "ssm"}
        return st if ssm else dict(st, ssm=None)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        st = self._stacked_states(batch)
        st["len"] = 0
        return st

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None):
        params = self.params()
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        cache = self.init_cache(B, S)
        h, new_states = self._forward(params, x, dict(cache, ssm=None))
        for i, st in enumerate(new_states):
            store_states(cache, i, st)
        cache["len"] = S
        logits = self._logits(params, h[:, -1:, :])
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One decode step.  tokens: (B, 1).  The cache's states are
        updated in place; the returned dict holds them with ``len`` + 1."""
        cfg = self.cfg
        params = self.params()
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        for i, lp in enumerate(unstack_layers(params["layers"])):
            h = apply_norm(lp["ln"], x, cfg.norm_kind)
            y, st_new = mamba_step(lp["mamba"], cfg, h, layer_state(cache, i))
            store_states(cache, i, st_new)
            x = x + y
        logits = self._logits(params, x)
        return logits[:, 0], dict(cache, len=int(cache["len"]) + 1)
