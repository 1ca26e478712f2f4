"""Cascade-stage transformer: window cross attention around the previous
stage's matches (counterpart of casmtr_tpu/models/cascade_transformer.py;
the 'local' self layers and the structured 'window' cross layers).  The
stack computes in ``transformer_dtype``, feeds kernel C q/k/v in
``table_dtype`` and returns float32 tokens for window matching."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from casmtr_tpu_torch.models.cascade_attention import LocalBlock
from casmtr_tpu_torch.models.precision import run
from casmtr_tpu_torch.models.transformer import (Mlp, table_dtype,
                                                 transformer_dtype)
from casmtr_tpu_torch.ops.propagation import get_propagations
from casmtr_tpu_torch.ops.quadtree import cascade_qtatt_b


def window_warp_idx(idx: torch.Tensor, window: np.ndarray, h: int, w: int
                    ) -> torch.Tensor:
    """Previous-stage match indices [B, HW] on the (h, w) grid -> window
    positions [B, HW, ww, 2] (y, x); a window crossing a border is shifted
    inward as a whole."""
    pos = torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w],
                      dim=-1)                                # [B, HW, 2]
    win = torch.as_tensor(window, dtype=pos.dtype, device=pos.device)
    idx_yx = pos[:, :, None, :] + win[None, None]            # [B, HW, ww, 2]
    under = idx_yx.min(dim=2, keepdim=True).values.clamp(max=0)
    over = idx_yx.max(dim=2, keepdim=True).values
    over_y = (over[..., 0] - (h - 1)).clamp(min=0)
    over_x = (over[..., 1] - (w - 1)).clamp(min=0)
    return idx_yx - under - torch.stack([over_y, over_x], dim=-1)


class CascadeQuadtreeAttention(nn.Module):
    """q/k/v projections around ``cascade_qtatt_b`` and the output
    projection."""

    def __init__(self, dim: int, num_heads: int, dilated: int = 1,
                 window_structured: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dilated = dilated
        self.window_structured = window_structured
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, target, hw_x, hw_t, idx, dtype=None, tables=None):
        """Computes in ``dtype`` (default: x's); kernel C reads q/k/v cast
        to ``tables`` (default: float32)."""
        B, L, C = x.shape
        dt = dtype or x.dtype
        tab = tables or torch.float32
        D = C // self.num_heads
        q = run(self.q_proj, x, dt).to(tab).reshape(B, L, self.num_heads, D)
        k = run(self.k_proj, target, dt).to(tab).reshape(B, -1,
                                                         self.num_heads, D)
        v = run(self.v_proj, target, dt).to(tab).reshape(B, -1,
                                                         self.num_heads, D)
        msg, up_idx = cascade_qtatt_b(q, k, v, idx, hw_x, hw_t,
                                      dilated=self.dilated,
                                      window_structured=self.window_structured)
        return run(self.proj, msg.reshape(B, L, C), dt), up_idx


class CascadeQuadtreeBlock(nn.Module):
    """PreNorm cascade cross-attention + DWConv-MLP; norm1 shared by x and
    target."""

    def __init__(self, dim: int, num_heads: int, dilated: int = 1,
                 mlp_ratio: float = 4.0, window_structured: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CascadeQuadtreeAttention(dim, num_heads, dilated,
                                             window_structured)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, target, hw_x, hw_t, idx, dtype=None, tables=None):
        dt = dtype or x.dtype
        x, target = x.to(dt), target.to(dt)
        y, up_idx = self.attn(run(self.norm1, x, dt),
                              run(self.norm1, target, dt), hw_x, hw_t, idx,
                              dt, tables)
        x = x + y
        return (x + self.mlp(run(self.norm2, x, dt), hw_x[0], hw_x[1], dt),
                up_idx)


class CascadeFeatureTransformer(nn.Module):
    """Cascade-level transformer: 'local' window self layers and window
    cross layers; cross layers update both images simultaneously."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        if config.self_attn_type != "local" and "self" in config.layer_names:
            raise NotImplementedError(
                f"cascade self-attention {config.self_attn_type!r} is not "
                "ported yet (ROADMAP queue A: the indoor recipe and the "
                "self-attention zoo)")
        if config.relative_pe or config.detector is not None:
            raise NotImplementedError(
                "cascade relative PE and the keypoint detector are not "
                "ported yet (ROADMAP queue A: the indoor recipe)")
        window, full_window = get_propagations(
            config.propagation, config.window_size, config.dilated)
        if full_window is not None:
            raise NotImplementedError(
                f"propagation {config.propagation!r} is not ported yet "
                "(ROADMAP queue A: the other propagations)")
        self.window = window
        aws = config.attn_window_size or config.window_size
        structured = config.propagation == "window" and config.dilated == 1
        self.layers = nn.ModuleList(
            LocalBlock(config.d_model, config.nhead, 4.0, aws)
            if name == "self" else
            CascadeQuadtreeBlock(config.d_model, config.nhead,
                                 dilated=config.dilated,
                                 window_structured=structured)
            for name in config.layer_names)

    def forward(self, feat0, feat1, idx_c01, idx_c10, hw0: Tuple[int, int],
                hw1: Tuple[int, int]):
        """feat0/feat1: [B, L, C] at this level; idx_c01/idx_c10: [B, L/4]
        previous-stage best-match indices on the TARGET image's 2x coarser
        grid.  Returns (feat0, feat1 float32, idx_c01 [B, L0, 4ww], idx_c10,
        corners01 [B, L0/4, 2], corners10)."""
        H0, W0 = hw0
        H1, W1 = hw1
        dt = transformer_dtype(feat0.device, self.training)
        tab = table_dtype(feat0.device)
        win01 = window_warp_idx(idx_c01, self.window, H1 // 2, W1 // 2)
        win10 = window_warp_idx(idx_c10, self.window, H0 // 2, W0 // 2)
        up01 = up10 = None
        for layer, name in zip(self.layers, self.config.layer_names):
            if name == "self":
                feat0 = layer(feat0, H0, W0, dt)
                feat1 = layer(feat1, H1, W1, dt)
            else:
                (feat0, up01), (feat1, up10) = (
                    layer(feat0, feat1, hw0, hw1, win01, dt, tab),
                    layer(feat1, feat0, hw1, hw0, win10, dt, tab))
        return (feat0.float(), feat1.float(), up01, up10, win01[:, :, 0, :],
                win10[:, :, 0, :])
