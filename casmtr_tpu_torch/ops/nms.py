"""Test-time keypoint filtering (counterpart of casmtr_tpu/ops/nms.py; the
released 4c and 2c recipes' ``maxpool_nms`` and the unfiltered threshold
only)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def maxpool_nms_mask(conf: torch.Tensor, hw: Tuple[int, int], window: int
                     ) -> torch.Tensor:
    """[B, L] -> [B, L] bool: the position is the argmax of the window
    centred on it, the first maximum in the window's row-major order winning
    ties (torch ``F.max_pool2d(return_indices=True)`` semantics)."""
    B = conf.shape[0]
    h, w = hw
    c2 = conf.reshape(B, h, w)
    pad = window // 2
    base = torch.arange(h * w, device=conf.device).reshape(h, w)
    cp = F.pad(c2, (pad, pad, pad, pad), value=float("-inf"))
    ip = F.pad(base[None].expand(B, h, w), (pad, pad, pad, pad), value=0)
    best_val = torch.full_like(c2, float("-inf"))
    best_idx = torch.zeros_like(c2, dtype=torch.long)
    for dy in range(window):
        for dx in range(window):
            v = cp[:, dy:dy + h, dx:dx + w]
            take = v > best_val
            best_val = torch.where(take, v, best_val)
            best_idx = torch.where(take, ip[:, dy:dy + h, dx:dx + w], best_idx)
    return (best_idx == base[None]).reshape(B, -1)


def post_process_mask(method: Optional[str], conf: torch.Tensor,
                      hw: Tuple[int, int], test_thr: float,
                      window: Optional[int] = None) -> torch.Tensor:
    """conf: [B, L] -> keep mask [B, L]."""
    if method is None:
        return conf > test_thr
    if method == "maxpool_nms":
        return maxpool_nms_mask(conf, hw, window) & (conf > test_thr)
    raise NotImplementedError(
        f"post-process '{method}' is not ported yet (ROADMAP queue A: "
        "the filter zoo)")
