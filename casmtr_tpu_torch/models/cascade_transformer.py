"""Cascade-stage transformer: window cross attention around the previous
stage's matches (counterpart of casmtr_tpu/models/cascade_transformer.py;
the 'local' and 'POLA' self layers, the structured 'window' cross layers,
the indoor recipe's windowed relative PE, and the learnable keypoint
detector head).  The stack computes in
``transformer_dtype`` (the POLA blocks in float32, as the JAX package's),
feeds the cross layers q/k/v in ``table_dtype`` and returns float32 tokens
for window matching."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from casmtr_tpu_torch.models.backbone.resnet_fpn import bn
from casmtr_tpu_torch.models.cascade_attention import LocalBlock
from casmtr_tpu_torch.models.pola import POLATransBlock
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
    projection; with a relative position bias ``rel_pos`` [B, H, L, 4Kw]
    the attention takes the gather path, else kernel C."""

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

    def forward(self, x, target, hw_x, hw_t, idx, dtype=None, tables=None,
                rel_pos=None):
        """Computes in ``dtype`` (default: x's); the attention reads q/k/v
        cast to ``tables`` (default: float32)."""
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
                                      dilated=self.dilated, rel_pos=rel_pos,
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

    def forward(self, x, target, hw_x, hw_t, idx, dtype=None, tables=None,
                rel_pos=None):
        dt = dtype or x.dtype
        x, target = x.to(dt), target.to(dt)
        y, up_idx = self.attn(run(self.norm1, x, dt),
                              run(self.norm1, target, dt), hw_x, hw_t, idx,
                              dt, tables, rel_pos)
        x = x + y
        return (x + self.mlp(run(self.norm2, x, dt), hw_x[0], hw_x[1], dt),
                up_idx)


class CascadeFeatureTransformer(nn.Module):
    """Cascade-level transformer: 'local' window or 'POLA' self layers and
    window cross layers; cross layers update both images simultaneously.
    With ``relative_pe`` the cross layers add the windowed relative
    position bias of ``h_pos_bias`` and ``w_pos_bias``.  With ``detector``
    'learnable' a head ``detector`` (3x3 conv, BatchNorm, SiLU, 1x1 conv,
    in float32) maps image0's output tokens to a keypoint heatmap in
    training."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        if (config.self_attn_type not in ("local", "POLA")
                and "self" in config.layer_names):
            raise NotImplementedError(
                f"cascade self-attention {config.self_attn_type!r} is not "
                "ported yet (ROADMAP queue A: the self-attention zoo)")
        if config.detector not in (None, "learnable"):
            raise NotImplementedError(f"detector {config.detector!r}")
        window, full_window = get_propagations(
            config.propagation, config.window_size, config.dilated)
        if full_window is not None:
            raise NotImplementedError(
                f"propagation {config.propagation!r} is not ported yet "
                "(ROADMAP queue A: the other propagations)")
        self.window = window
        aws = config.attn_window_size or config.window_size
        structured = config.propagation == "window" and config.dilated == 1

        def self_layer():
            if config.self_attn_type == "POLA":
                return POLATransBlock(config.d_model, config.nhead, aws)
            return LocalBlock(config.d_model, config.nhead, 4.0, aws)

        self.layers = nn.ModuleList(
            self_layer() if name == "self" else
            CascadeQuadtreeBlock(config.d_model, config.nhead,
                                 dilated=config.dilated,
                                 window_structured=structured)
            for name in config.layer_names)
        if config.relative_pe:
            # LB: the offset range of the windowed relative PE
            self.LB = config.window_size * (2 if config.sr_ratio == 2 else 6)
            n = self.LB * 2 + config.sr_ratio
            self.h_pos_bias = nn.Embedding(n, config.nhead)
            self.w_pos_bias = nn.Embedding(n, config.nhead)
        d = config.d_model
        self.detector = (nn.Sequential(nn.Conv2d(d, d, 3, padding=1), bn(d),
                                       nn.SiLU(), nn.Conv2d(d, 1, 1))
                         if config.detector == "learnable" else None)

    def _relative_pe(self, hw_c_q, hw_c_t, next_idx_c, window_idx, H: int,
                     W: int) -> torch.Tensor:
        """The windowed relative PE [B, nhead, H*W, 4ww] of a query image at
        this level (H, W): for each query cell and each candidate of its
        window, the offset between the candidate and the query's 1/8 match
        (``next_idx_c`` [B, h*w] on the target's 1/8 grid ``hw_c_t``) plus
        the query's place inside its 1/8 cell, both (x, y), shifted by LB
        and 2 LB, clipped into the tables, through ``w_pos_bias`` (x) and
        ``h_pos_bias`` (y).  window_idx: [B, (H/2)*(W/2), ww, 2] (y, x) on
        the target's 2x coarser grid of this level."""
        h, w = hw_c_q
        w1 = hw_c_t[1]
        s = H // h
        W1 = w1 * s
        B = next_idx_c.shape[0]
        LB = self.LB
        dev = next_idx_c.device
        ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        # (x, y) place of each cell inside its 1/8 cell
        src = torch.stack([xs % s, ys % s], -1)[None, :, None]  # [1, HW, 1, 2]
        # the 1/8 match of each cell's 1/8 cell, at this level's scale
        nxt = next_idx_c[:, (ys // s) * w + xs // s]            # [B, HW]
        tgt = torch.stack([nxt % w1, nxt // w1], -1) * s + (s // 2 - 1)
        # each cell's window candidates on the target's grid, (x, y)
        wi = window_idx * 2
        cands = torch.stack([(wi[..., 0] + dr) * W1 + wi[..., 1] + dc
                             for dr in (0, 1) for dc in (0, 1)], dim=3)
        cands = cands.reshape(B, cands.shape[1], -1)         # [B, HW/4, 4ww]
        cands = cands[:, (ys // 2) * (W // 2) + xs // 2]     # [B, HW, 4ww]
        wi = torch.stack([cands % W1, cands // W1], -1)      # [B, HW, 4ww, 2]
        rel = src - (tgt[:, :, None] - wi + LB) + 2 * LB
        rel = rel.clamp(0, self.w_pos_bias.num_embeddings - 1)
        bias = self.w_pos_bias(rel[..., 0]) + self.h_pos_bias(rel[..., 1])
        return bias.permute(0, 3, 1, 2)                      # [B, nh, HW, 4ww]

    def forward(self, feat0, feat1, idx_c01, idx_c10, hw0: Tuple[int, int],
                hw1: Tuple[int, int], hw0_c=None, hw1_c=None,
                next_idx_c01=None, next_idx_c10=None):
        """feat0/feat1: [B, L, C] at this level; idx_c01/idx_c10: [B, L/4]
        previous-stage best-match indices on the TARGET image's 2x coarser
        grid; with ``relative_pe`` also the 1/8 grids hw0_c/hw1_c and the
        1/8 best matches next_idx_c01/next_idx_c10 [B, h*w].  Returns
        (feat0, feat1 float32, idx_c01 [B, L0, 4ww], idx_c10, corners01
        [B, L0/4, 2], corners10, heatmap0 [B, H0, W0] float32 from the
        detector head in training, else None)."""
        H0, W0 = hw0
        H1, W1 = hw1
        dt = transformer_dtype(feat0.device, self.training)
        tab = table_dtype(feat0.device)
        win01 = window_warp_idx(idx_c01, self.window, H1 // 2, W1 // 2)
        win10 = window_warp_idx(idx_c10, self.window, H0 // 2, W0 // 2)
        rel01 = rel10 = None
        if self.config.relative_pe:
            rel01 = self._relative_pe(hw0_c, hw1_c, next_idx_c01, win01, H0,
                                      W0)
            rel10 = self._relative_pe(hw1_c, hw0_c, next_idx_c10, win10, H1,
                                      W1)
        up01 = up10 = None
        for layer, name in zip(self.layers, self.config.layer_names):
            if name == "self":
                if isinstance(layer, POLATransBlock):
                    feat0, feat1 = layer(feat0, H0, W0), layer(feat1, H1, W1)
                else:
                    feat0 = layer(feat0, H0, W0, dt)
                    feat1 = layer(feat1, H1, W1, dt)
            else:
                (feat0, up01), (feat1, up10) = (
                    layer(feat0, feat1, hw0, hw1, win01, dt, tab, rel01),
                    layer(feat1, feat0, hw1, hw0, win10, dt, tab, rel10))
        feat0, feat1 = feat0.float(), feat1.float()
        heat0 = None
        if self.detector is not None and self.training:
            grid = feat0.transpose(1, 2).reshape(feat0.shape[0], -1, H0, W0)
            heat0 = self.detector(grid)[:, 0]
        return (feat0, feat1, up01, up10, win01[:, :, 0, :],
                win10[:, :, 0, :], heat0)
