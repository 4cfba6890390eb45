"""Decoder-only transformer LM (dense and MoE families).

Layer parameters are stacked along a leading L axis, as the JAX
package's ``DecoderLM`` stacks them, and the forward pass is a loop over
layers in place of its ``lax.scan``.  Per-layer *structure* differences
(gemma2's local/global alternation) are per-layer window sizes, by
absolute layer index.

Entry points (used by train/serve/launch):
  * ``init``         — draw the parameters
  * ``loss``         — next-token CE (+ MoE aux), seq-chunked for big vocabs
  * ``prefill``      — build KV caches, return last-position logits
  * ``decode_step``  — one token with KV caches
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..dist.sharding import constrain_residual
from ..train.remat import maybe_remat
from .blocks import (LMModule, Params, _dense_init, apply_attention,
                     apply_mlp, apply_moe, apply_norm, ce_sum, embed_lookup,
                     init_attention, init_mlp, init_moe, init_norm,
                     make_positions, stack_spec, unstack_layers)

__all__ = ["DecoderLM"]

_PREFILL_CHUNK_THRESHOLD = 16384   # switch attention to streaming form
_KV_CHUNK = 1024
_LOSS_VOCAB_THRESHOLD = 65536      # seq-chunk the CE loss above this vocab
_LOSS_CHUNK = 512


class DecoderLM(LMModule):
    """Dense or MoE decoder LM defined by a ModelConfig."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(cfg.family)
        super().__init__(cfg, device, generator)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def _n_dense(self) -> int:
        cfg = self.cfg
        return cfg.first_dense_layers if cfg.n_experts else 0

    def _layer_spec(self, moe: bool) -> Params:
        cfg, dt = self.cfg, self.dtype
        p: Params = {
            "ln1": init_norm(cfg, dt),
            "attn": init_attention(cfg, dt),
            "ln2": init_norm(cfg, dt),
        }
        if cfg.post_norms:
            p["ln1_post"] = init_norm(cfg, dt)
            p["ln2_post"] = init_norm(cfg, dt)
        if moe:
            p["moe"] = init_moe(cfg, dt)
        else:
            p["mlp"] = init_mlp(cfg, dt)
        return p

    def _param_spec(self) -> Params:
        cfg, dt = self.cfg, self.dtype
        n_dense = self._n_dense()
        params: Params = {
            "embed": _dense_init((cfg.vocab, cfg.d_model), dt),
            "final_norm": init_norm(cfg, dt),
        }
        if not cfg.tie_embeddings:
            params["head"] = _dense_init((cfg.d_model, cfg.vocab), dt)
        if n_dense:
            params["dense_layers"] = stack_spec(self._layer_spec(False),
                                                (n_dense,))
        params["layers"] = stack_spec(self._layer_spec(bool(cfg.n_experts)),
                                      (cfg.n_layers - n_dense,))
        return params

    # ------------------------------------------------------------------
    # Per-layer windows (gemma2 local/global alternation)
    # ------------------------------------------------------------------
    def _windows(self, n: int, offset: int = 0) -> List[int]:
        cfg = self.cfg
        if cfg.local_global_alternate and cfg.sliding_window:
            return [cfg.sliding_window if i % 2 == 0 else 0
                    for i in range(offset, offset + n)]
        return [cfg.sliding_window] * n

    # ------------------------------------------------------------------
    # Layer body
    # ------------------------------------------------------------------
    def _block(self, lp: Params, x, positions, window: int, *, moe: bool,
               kv_chunk: int = 0, cache=None, cache_len=None):
        cfg = self.cfg
        h = apply_norm(lp["ln1"], x, cfg.norm_kind)
        attn_out, new_cache = apply_attention(
            lp["attn"], cfg, h, positions, cache=cache, cache_len=cache_len,
            causal=True, window=window, kv_chunk=kv_chunk)
        if cfg.post_norms:
            attn_out = apply_norm(lp["ln1_post"], attn_out, cfg.norm_kind)
        x = x + attn_out
        h = apply_norm(lp["ln2"], x, cfg.norm_kind)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if moe:
            mlp_out, aux = apply_moe(lp["moe"], cfg, h)
        else:
            mlp_out = apply_mlp(lp["mlp"], cfg, h)
        if cfg.post_norms:
            mlp_out = apply_norm(lp["ln2_post"], mlp_out, cfg.norm_kind)
        return x + mlp_out, aux, new_cache

    # ------------------------------------------------------------------
    # Forward over all layers
    # ------------------------------------------------------------------
    def _forward(self, params: Params, x, positions, *, kv_chunk: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sequence forward (no caches).  Returns (hidden, aux_loss)."""
        cfg = self.cfg
        n_dense = self._n_dense()
        wins = self._windows(n_dense)
        dense = unstack_layers(params["dense_layers"]) if n_dense else []
        for i in range(n_dense):
            x, _, _ = self._block(dense[i], x, positions, wins[i], moe=False,
                                  kv_chunk=kv_chunk)
        moe = bool(cfg.n_experts)
        wins = self._windows(cfg.n_layers - n_dense, offset=n_dense)

        def one_layer(lp, x, win):
            y, a, _ = self._block(lp, x, positions, win, moe=moe,
                                  kv_chunk=kv_chunk)
            return y, a

        one_layer = maybe_remat(one_layer)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = unstack_layers(params["layers"])
        for i, win in enumerate(wins):
            x = constrain_residual(x)
            x, a = one_layer(layers[i], x, win)
            aux = aux + a
        return x, aux

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(params["embed"], tokens).to(self.dtype)

    def _positions(self, batch: Dict[str, Any], B: int, S: int):
        cfg = self.cfg
        positions = batch.get("mrope_positions") if cfg.mrope else None
        if positions is None:
            positions = make_positions(B, S, device=self.device)
            if cfg.mrope:
                positions = positions[None].expand(3, B, S)
        return positions

    def _embed_batch(self, params: Params, batch: Dict[str, Any]):
        x = self._embed(params, batch["tokens"])
        if "extra_embeds" in batch:        # VLM stub frontend outputs
            x = x + batch["extra_embeds"].to(x.dtype)
        return x

    # ------------------------------------------------------------------
    # Training loss
    # ------------------------------------------------------------------
    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        params = self.params()
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        B, S = tokens.shape
        positions = self._positions(batch, B, S)
        x = self._embed_batch(params, batch)
        kv_chunk = _KV_CHUNK if S >= _PREFILL_CHUNK_THRESHOLD else 0
        # experiment lever: force streaming attention at train time
        # (REPRO_TRAIN_KV_CHUNK=1024), as the JAX package reads it
        env_chunk = int(os.environ.get("REPRO_TRAIN_KV_CHUNK", "0"))
        if env_chunk:
            kv_chunk = env_chunk
        h, aux = self._forward(params, x, positions, kv_chunk=kv_chunk)

        ce, denom = _chunked_ce(lambda hh: self._logits(params, hh), h,
                                targets, mask,
                                chunked=cfg.vocab >= _LOSS_VOCAB_THRESHOLD)
        loss = ce / denom
        if cfg.n_experts:
            loss = loss + 0.01 * aux / cfg.n_layers
        return loss, {"ce": ce / denom, "aux": aux}

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        K, hd = cfg.n_kv_heads, cfg.hd()
        n_dense = self._n_dense()
        n_scan = cfg.n_layers - n_dense

        def zeros(n):
            return torch.zeros((n, batch, max_len, K, hd), dtype=self.dtype,
                               device=self.device)

        cache: Dict[str, Any] = {"k": zeros(n_scan), "v": zeros(n_scan),
                                 "len": 0}
        if n_dense:
            cache["k_dense"] = zeros(n_dense)
            cache["v_dense"] = zeros(n_dense)
        return cache

    def _cached_layers(self, params: Params, x, positions, cache, pos: int,
                       kv_chunk: int = 0):
        """Every layer over ``x`` with its KV cache, written in place."""
        cfg = self.cfg
        n_dense = self._n_dense()
        wins = self._windows(n_dense)
        dense = unstack_layers(params["dense_layers"]) if n_dense else []
        for i in range(n_dense):
            x, _, _ = self._block(
                dense[i], x, positions,
                wins[i], moe=False, kv_chunk=kv_chunk,
                cache=(cache["k_dense"][i], cache["v_dense"][i]),
                cache_len=pos)
        moe = bool(cfg.n_experts)
        wins = self._windows(cfg.n_layers - n_dense, offset=n_dense)
        layers = unstack_layers(params["layers"])
        for i, win in enumerate(wins):
            x = constrain_residual(x)
            x, _, _ = self._block(layers[i], x,
                                  positions, win, moe=moe,
                                  kv_chunk=kv_chunk,
                                  cache=(cache["k"][i], cache["v"][i]),
                                  cache_len=pos)
        return x

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the prompt, build caches, return last-token logits."""
        params = self.params()
        B, S = batch["tokens"].shape
        max_len = max_len or S
        positions = self._positions(batch, B, S)
        x = self._embed_batch(params, batch)
        kv_chunk = _KV_CHUNK if S >= _PREFILL_CHUNK_THRESHOLD else 0
        cache = self.init_cache(B, max_len)
        x = self._cached_layers(params, x, positions, cache, 0, kv_chunk)
        cache["len"] = S
        logits = self._logits(params, x[:, -1:, :])
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step.  tokens: (B, 1).  The cache's tensors are
        updated in place; the returned dict holds them with ``len`` + 1."""
        params = self.params()
        B = tokens.shape[0]
        pos = int(cache["len"])
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=self.device)
        if self.cfg.mrope:
            positions = positions[None].expand(3, B, 1)
        x = self._embed(params, tokens)
        x = self._cached_layers(params, x, positions, cache, pos)
        logits = self._logits(params, x)
        return logits[:, 0], dict(cache, len=pos + 1)


def _chunked_ce(logits_fn: Callable, h: torch.Tensor, targets: torch.Tensor,
                mask: Optional[torch.Tensor], *, chunked: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of CE over (possibly seq-chunked) positions + valid count.

    Chunking keeps the (B, chunk, V) logits buffer bounded for 150k-250k
    vocabularies — the full (B, S, V) tensor would dominate memory.
    """
    B, S, _ = h.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    denom = torch.clamp(mask.sum(), min=1.0)

    def ce_of(hh, tt, mm):
        return ce_sum(logits_fn(hh), tt, mm)           # (B, c, V) f32

    if not chunked or S % _LOSS_CHUNK or S <= _LOSS_CHUNK:
        return ce_of(h, targets, mask), denom

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // _LOSS_CHUNK):
        sl = slice(c * _LOSS_CHUNK, (c + 1) * _LOSS_CHUNK)
        # recompute chunk logits in backward
        tot = tot + checkpoint(ce_of, h[:, sl], targets[:, sl], mask[:, sl],
                               use_reentrant=False)
    return tot, denom
