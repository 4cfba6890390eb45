"""Plain version: per-pixel GMM background subtraction (same math as
apps.wami.components)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["change_detection_ref"]

_GMM_K = 3           # mixture size


def change_detection_ref(gray: torch.Tensor, mu: torch.Tensor,
                         var: torch.Tensor, w: torch.Tensor, *,
                         lr: float = 0.05, mahal_thresh: float = 6.25,
                         fg_thresh: float = 0.7
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Per-pixel Gaussian-mixture background subtraction (K=3).

    Returns (mask, mu', var', w').  State arrays have shape (H, W, K).
    """
    x = gray[..., None]
    d2 = (x - mu) ** 2 / torch.clamp(var, min=1e-4)
    match = d2 < mahal_thresh                       # (H, W, K)
    any_match = torch.any(match, dim=-1)
    # best (lowest-d2) matching mixture component; argmin takes the
    # first index among ties
    d2_masked = torch.where(match, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(d2_masked, dim=-1)
    onehot = (F.one_hot(best, _GMM_K).to(gray.dtype)
              * any_match[..., None].to(gray.dtype))

    mu_n = mu + onehot * lr * (x - mu)
    var_n = var + onehot * lr * ((x - mu) ** 2 - var)
    w_n = (1 - lr) * w + lr * onehot
    # no match: replace weakest component with a fresh one centred at x
    weakest = torch.argmin(w, dim=-1)
    wh = (F.one_hot(weakest, _GMM_K).to(gray.dtype)
          * (~any_match)[..., None].to(gray.dtype))
    mu_n = mu_n * (1 - wh) + wh * x
    var_n = var_n * (1 - wh) + wh * 25.0
    w_n = w_n * (1 - wh) + wh * lr
    w_n = w_n / torch.sum(w_n, dim=-1, keepdim=True)
    # foreground: matched component is low-weight, or no match at all
    matched_w = torch.sum(onehot * w, dim=-1)
    mask = (~any_match) | (matched_w < (1.0 - fg_thresh))
    return mask, mu_n, var_n, w_n
