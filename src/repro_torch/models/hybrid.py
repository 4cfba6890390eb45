"""Zamba2-style hybrid LM: Mamba2 backbone + one SHARED attention block.

The shared block (attention + gated MLP, one copy of weights) fires
before every ``shared_attn_every``-th group of Mamba layers — the 54
Mamba layers form 9 super-blocks of 6, stacked as ``(sites, every, ...)``
as the JAX package stacks them, and one set of attention parameters
serves every site.

Each invocation site keeps its own KV cache (weights are shared, caches
are not).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.sharding import constrain_residual
from ..train.remat import maybe_remat
from .blocks import (LMModule, Params, _dense_init, apply_attention,
                     apply_mlp, apply_norm, embed_lookup, init_attention,
                     init_mlp, init_norm, make_positions, masked_ce,
                     stack_spec, unstack_layers)
from .ssm import init_mamba, init_ssm_state, mamba_sequence, mamba_step
from .ssm_lm import layer_state, store_states

__all__ = ["HybridLM"]


class HybridLM(LMModule):
    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.family != "hybrid" or cfg.shared_attn_every <= 0:
            raise ValueError(f"{cfg.family} with shared_attn_every="
                             f"{cfg.shared_attn_every}")
        if cfg.n_layers % cfg.shared_attn_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple "
                             f"of shared_attn_every {cfg.shared_attn_every}")
        self.n_sites = cfg.n_layers // cfg.shared_attn_every
        super().__init__(cfg, device, generator)

    # ------------------------------------------------------------------
    def _param_spec(self) -> Params:
        cfg, dt = self.cfg, self.dtype
        layer = {"ln": init_norm(cfg, dt), "mamba": init_mamba(cfg, dt)}
        params: Params = {
            "embed": _dense_init((cfg.vocab, cfg.d_model), dt),
            "final_norm": init_norm(cfg, dt),
            # (sites, every, ...) for the super-block loop
            "layers": stack_spec(layer, (self.n_sites,
                                         cfg.shared_attn_every)),
            "shared_ln1": init_norm(cfg, dt),
            "shared_attn": init_attention(cfg, dt),
            "shared_ln2": init_norm(cfg, dt),
            "shared_mlp": init_mlp(cfg, dt),
        }
        if not cfg.tie_embeddings:
            params["head"] = _dense_init((cfg.d_model, cfg.vocab), dt)
        return params

    # ------------------------------------------------------------------
    def _shared_block(self, params, x, positions, *, cache=None,
                      cache_len=None, kv_chunk=0, fused_ok=False):
        cfg = self.cfg
        h = apply_norm(params["shared_ln1"], x, cfg.norm_kind)
        a, new_cache = apply_attention(params["shared_attn"], cfg, h,
                                       positions, cache=cache,
                                       cache_len=cache_len, causal=True,
                                       kv_chunk=kv_chunk,
                                       fused_ok=fused_ok)
        x = x + a
        h = apply_norm(params["shared_ln2"], x, cfg.norm_kind)
        return x + apply_mlp(params["shared_mlp"], cfg, h), new_cache

    # ------------------------------------------------------------------
    def _forward(self, params, x, positions, states, *, caches=None,
                 cache_len=None, kv_chunk=0, step=False,
                 fused_ok=False):
        """Every super-block from ``states`` ((sites, every)-stacked; an
        SSM state of None is a fresh start).  With ``caches``, each site's
        attention K/V are written into its cache and every new Mamba state
        into ``caches`` (in place); without, the states are read only (the
        loss)."""
        cfg = self.cfg
        fn = mamba_step if step else mamba_sequence

        def inner_fn(ilp, x, ist):
            h = apply_norm(ilp["ln"], x, cfg.norm_kind)
            y, ist_new = fn(ilp["mamba"], cfg, h, ist)
            return x + y, ist_new

        inner_fn = maybe_remat(inner_fn)
        sites = [unstack_layers(site)
                 for site in unstack_layers(params["layers"])]
        for g in range(self.n_sites):
            x = constrain_residual(x)
            x, _ = self._shared_block(
                params, x, positions,
                cache=None if caches is None else (caches["k"][g],
                                                   caches["v"][g]),
                cache_len=cache_len, kv_chunk=kv_chunk,
                fused_ok=fused_ok)
            for e in range(cfg.shared_attn_every):
                x, st_new = inner_fn(sites[g][e], x,
                                     layer_state(states, g, e))
                if caches is not None:
                    store_states(caches, (g, e), st_new)
        return x

    # ------------------------------------------------------------------
    def _stacked_states(self, batch: int, ssm: bool = True):
        """Zero states of every Mamba layer; without ``ssm``, the SSM
        state is None (a fresh start)."""
        cfg = self.cfg
        one = init_ssm_state(cfg, batch, self.dtype, self.device)
        lead = (self.n_sites, cfg.shared_attn_every)
        st = {k: a.new_zeros(lead + a.shape) for k, a in one.items()
              if ssm or k != "ssm"}
        return st if ssm else dict(st, ssm=None)

    def loss(self, batch) -> Tuple[torch.Tensor, Dict]:
        params = self.params()
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        B, S = tokens.shape
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        positions = make_positions(B, S, device=self.device)
        kv_chunk = 1024 if S >= 16384 else 0
        h = self._forward(params, x, positions,
                          self._stacked_states(B, ssm=False),
                          kv_chunk=kv_chunk, fused_ok=True)
        ce = masked_ce(self._logits(params, h), targets, mask)
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        st = self._stacked_states(batch)
        K, hd = cfg.n_kv_heads, cfg.hd()
        shape = (self.n_sites, batch, max_len, K, hd)
        return {
            "ssm": st["ssm"], "conv": st["conv"],
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "len": 0,
        }

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None):
        params = self.params()
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = max_len or S
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        positions = make_positions(B, S, device=self.device)
        cache = self.init_cache(B, max_len)
        kv_chunk = 1024 if S >= 16384 else 0
        h = self._forward(params, x, positions, dict(cache, ssm=None),
                          caches=cache, cache_len=0, kv_chunk=kv_chunk)
        cache["len"] = S
        logits = self._logits(params, h[:, -1:, :])
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One decode step.  tokens: (B, 1).  The cache's tensors are
        updated in place; the returned dict holds them with ``len`` + 1."""
        params = self.params()
        B = tokens.shape[0]
        pos = int(cache["len"])
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        h = self._forward(params, x, positions, cache, caches=cache,
                          cache_len=pos, step=True)
        logits = self._logits(params, h)
        return logits[:, 0], dict(cache, len=pos + 1)
