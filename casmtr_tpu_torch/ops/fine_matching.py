"""Fine-level window extraction and sub-pixel matching (counterpart of
casmtr_tpu/ops/fine_matching.py)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from casmtr_tpu_torch.structs import Matches


def extract_windows(feat: torch.Tensor, b_ids: torch.Tensor,
                    center_flat: torch.Tensor, hw_c: Tuple[int, int],
                    stride: int, w_size: int) -> torch.Tensor:
    """Gather [M, W*W, C] windows from [B, Hf, Wf, C] centred at coarse-grid
    positions (centre (r*stride, c*stride)); out-of-bounds taps are zero."""
    B, Hf, Wf, C = feat.shape
    hc, wc = hw_c
    r = torch.div(center_flat, wc, rounding_mode="floor") * stride
    c = (center_flat % wc) * stride
    off = torch.arange(w_size, device=feat.device) - w_size // 2
    rows = r[:, None] + off[None, :]                     # [M, W]
    cols = c[:, None] + off[None, :]
    in_b = ((rows >= 0) & (rows < Hf))[:, :, None] & \
           ((cols >= 0) & (cols < Wf))[:, None, :]       # [M, W, W]
    win = feat[b_ids[:, None, None], rows.clamp(0, Hf - 1)[:, :, None],
               cols.clamp(0, Wf - 1)[:, None, :]]        # [M, W, W, C]
    win = torch.where(in_b[..., None], win, torch.zeros((), device=feat.device))
    return win.reshape(win.shape[0], w_size * w_size, C)


class FineResult(NamedTuple):
    expec_f: torch.Tensor      # [M, 3] (dx, dy, std)
    coords_norm: torch.Tensor  # [M, 2]


def fine_match(feat0_win: torch.Tensor, feat1_win: torch.Tensor) -> FineResult:
    """Centre-pixel vs window correlation -> softmax heatmap -> soft-argmax
    and its standard deviation."""
    M, WW, C = feat0_win.shape
    W = int(WW ** 0.5)
    f0c = feat0_win[:, WW // 2]
    sim = torch.einsum("mc,mrc->mr", f0c.float(), feat1_win.float())
    heat = torch.softmax(sim / (C ** 0.5), dim=1)        # [M, WW]
    grid = torch.linspace(-1.0, 1.0, W, device=heat.device)
    gx = grid[None, :].expand(W, W).reshape(WW)
    gy = grid[:, None].expand(W, W).reshape(WW)
    coords = torch.stack([heat @ gx, heat @ gy], dim=-1)  # [M, 2] in [-1, 1]
    g2 = torch.stack([gx, gy], dim=-1) ** 2               # [WW, 2]
    var = heat @ g2 - coords ** 2
    std = torch.sqrt(var.clamp(min=1e-10)).sum(dim=-1)
    return FineResult(torch.cat([coords, std[:, None]], dim=-1), coords)


def fine_keypoints(matches: Matches, coords_norm: torch.Tensor, w_size: int,
                   scale_f: float, scale1=None):
    """mkpts1_f = mkpts1_c + coords_norm * (W//2) * scale; mkpts0 unchanged.
    scale1: optional [M, 2] original-image resize factors."""
    delta = coords_norm * (w_size // 2) * scale_f
    if scale1 is not None:
        delta = delta * scale1
    return matches.mkpts0, matches.mkpts1 + delta
