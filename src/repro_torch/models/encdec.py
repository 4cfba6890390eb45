"""Whisper-style encoder-decoder (audio backbone only, per assignment).

The conv audio frontend is a STUB: the batch carries precomputed frame
embeddings (B, frames, d_model) under ``"frames"``.  Positions use
on-the-fly sinusoidal embeddings on both sides, as in the JAX package's
``EncDecLM`` (no learned decoder position table).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..dist.sharding import (batch_only, constrain_residual,
                             gather_unless_divides)
from ..train.remat import maybe_remat
from .blocks import (LMModule, Params, _dense_init, apply_attention,
                     apply_mlp, apply_norm, embed_lookup, init_attention,
                     init_mlp, init_norm, make_positions, masked_ce,
                     stack_spec, unstack_layers)

__all__ = ["EncDecLM"]


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) int positions -> (B, S, d) float32 sinusoidal embeddings."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecLM(LMModule):
    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.family != "encdec":
            raise ValueError(cfg.family)
        super().__init__(cfg, device, generator)

    # ------------------------------------------------------------------
    def _param_spec(self) -> Params:
        cfg, dt = self.cfg, self.dtype
        enc_layer = {"ln1": init_norm(cfg, dt),
                     "attn": init_attention(cfg, dt),
                     "ln2": init_norm(cfg, dt),
                     "mlp": init_mlp(cfg, dt)}
        dec_layer = {"ln1": init_norm(cfg, dt),
                     "self_attn": init_attention(cfg, dt),
                     "ln_x": init_norm(cfg, dt),
                     "cross_attn": init_attention(cfg, dt),
                     "ln2": init_norm(cfg, dt),
                     "mlp": init_mlp(cfg, dt)}
        return {
            "embed": _dense_init((cfg.vocab, cfg.d_model), dt),
            "enc_layers": stack_spec(enc_layer, (cfg.n_encoder_layers,)),
            "enc_norm": init_norm(cfg, dt),
            "dec_layers": stack_spec(dec_layer, (cfg.n_layers,)),
            "final_norm": init_norm(cfg, dt),
        }

    # ------------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, F, d) stub-frontend embeddings -> encoder states."""
        cfg = self.cfg
        B, F, _ = frames.shape
        pos = make_positions(B, F, device=frames.device)
        x = frames.to(self.dtype)
        x = x + _sinusoidal(pos, cfg.d_model).to(x.dtype)

        def one_layer(lp, x):
            h = apply_norm(lp["ln1"], x, cfg.norm_kind)
            a, _ = apply_attention(lp["attn"], cfg, h, pos, causal=False)
            x = x + a
            h = apply_norm(lp["ln2"], x, cfg.norm_kind)
            return x + apply_mlp(lp["mlp"], cfg, h)

        one_layer = maybe_remat(one_layer)
        layers = unstack_layers(params["enc_layers"])
        for i in range(cfg.n_encoder_layers):
            x = constrain_residual(x)
            x = one_layer(layers[i], x)
        return apply_norm(params["enc_norm"], x, cfg.norm_kind)

    def _cross_kv(self, params, enc: torch.Tensor):
        """Per-decoder-layer cross-attention K/V, stacked on L."""
        cfg = self.cfg
        B, F, _ = enc.shape
        K, hd = cfg.n_kv_heads, cfg.hd()
        ca = params["dec_layers"]["cross_attn"]
        ks = [gather_unless_divides(enc @ ca["wk"][i], 2, K)
              .reshape(B, F, K, hd) for i in range(cfg.n_layers)]
        vs = [gather_unless_divides(enc @ ca["wv"][i], 2, K)
              .reshape(B, F, K, hd) for i in range(cfg.n_layers)]
        return torch.stack(ks), torch.stack(vs)

    def _dec_block(self, lp, x, positions, enc_pos, *, cross_kv,
                   self_cache=None, cache_len=None, kv_chunk=0):
        cfg = self.cfg
        h = apply_norm(lp["ln1"], x, cfg.norm_kind)
        a, new_cache = apply_attention(lp["self_attn"], cfg, h, positions,
                                       cache=self_cache, cache_len=cache_len,
                                       causal=True, kv_chunk=kv_chunk)
        x = x + a
        h = apply_norm(lp["ln_x"], x, cfg.norm_kind)
        c, _ = apply_attention(lp["cross_attn"], cfg, h, positions,
                               kv=cross_kv, kv_positions=enc_pos,
                               causal=False)
        x = x + c
        h = apply_norm(lp["ln2"], x, cfg.norm_kind)
        return x + apply_mlp(lp["mlp"], cfg, h), new_cache

    def _decode_seq(self, params, tokens, n_frames: int, *, cross_kv,
                    caches=None, cache_len=None, kv_chunk=0):
        """The decoder over ``tokens``.  With ``caches``, self-attention
        K/V are written into them in place from ``cache_len``."""
        cfg = self.cfg
        B, S = tokens.shape
        offset = 0 if cache_len is None else cache_len
        positions = make_positions(B, S, offset=offset, device=self.device)
        enc_pos = make_positions(B, n_frames, device=self.device)
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        x = x + _sinusoidal(positions, cfg.d_model).to(x.dtype)
        ck, cv = cross_kv

        layers = unstack_layers(params["dec_layers"])
        if caches is None:
            def one_layer(lp, x, k1, v1):
                y, _ = self._dec_block(lp, x, positions, enc_pos,
                                       cross_kv=(k1, v1), kv_chunk=kv_chunk)
                return y

            one_layer = maybe_remat(one_layer)
            for i in range(cfg.n_layers):
                x = constrain_residual(x)
                x = one_layer(layers[i], x, ck[i], cv[i])
            return x
        for i in range(cfg.n_layers):
            x = constrain_residual(x)
            x, _ = self._dec_block(layers[i], x,
                                   positions, enc_pos, cross_kv=(ck[i], cv[i]),
                                   self_cache=(caches["k"][i],
                                               caches["v"][i]),
                                   cache_len=cache_len, kv_chunk=kv_chunk)
        return x

    def _logits(self, params, h):
        """Always tied to the embedding, never soft-capped."""
        cfg = self.cfg
        h = batch_only(apply_norm(params["final_norm"], h, cfg.norm_kind))
        return (h @ params["embed"].T.to(h.dtype)).float()

    # ------------------------------------------------------------------
    def loss(self, batch) -> Tuple[torch.Tensor, Dict]:
        params = self.params()
        tokens, targets = batch["tokens"], batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
        enc = self.encode(params, batch["frames"])
        kv_chunk = 1024 if tokens.shape[1] >= 16384 else 0
        h = self._decode_seq(params, tokens, enc.shape[1],
                             cross_kv=self._cross_kv(params, enc),
                             kv_chunk=kv_chunk)
        ce = masked_ce(self._logits(params, h), targets, mask)
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        K, hd = cfg.n_kv_heads, cfg.hd()
        L, F = cfg.n_layers, cfg.encoder_frames

        def zeros(*shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return {
            "k": zeros(L, batch, max_len, K, hd),
            "v": zeros(L, batch, max_len, K, hd),
            "cross_k": zeros(L, batch, F, K, hd),
            "cross_v": zeros(L, batch, F, K, hd),
            "len": 0,
        }

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None):
        params = self.params()
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_len = max_len or S
        enc = self.encode(params, batch["frames"])
        caches = self.init_cache(B, max_len)
        caches["cross_k"], caches["cross_v"] = self._cross_kv(params, enc)
        kv_chunk = 1024 if S >= 16384 else 0
        h = self._decode_seq(params, tokens, enc.shape[1],
                             cross_kv=(caches["cross_k"], caches["cross_v"]),
                             caches=caches, cache_len=0, kv_chunk=kv_chunk)
        caches["len"] = S
        logits = self._logits(params, h[:, -1:, :])
        return logits[:, 0], caches

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One decode step.  tokens: (B, 1).  The encoder states are
        folded into ``cross_k``/``cross_v``; the self-attention caches are
        updated in place and the returned dict holds them with ``len`` +
        1."""
        params = self.params()
        pos = int(cache["len"])
        h = self._decode_seq(params, tokens, self.cfg.encoder_frames,
                             cross_kv=(cache["cross_k"], cache["cross_v"]),
                             caches=cache, cache_len=pos)
        logits = self._logits(params, h)
        return logits[:, 0], dict(cache, len=pos + 1)
