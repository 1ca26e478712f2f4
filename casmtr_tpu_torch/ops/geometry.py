"""Depth-based keypoint warping (counterpart of casmtr_tpu/ops/geometry.py)."""

from __future__ import annotations

from typing import Tuple

import torch


def _sample_depth(depth: torch.Tensor, pts_long: torch.Tensor) -> torch.Tensor:
    """depth: [B, H, W]; pts_long: [B, L, 2] (x, y) integer -> [B, L]."""
    h, w = depth.shape[1:3]
    x = pts_long[..., 0].clamp(0, w - 1)
    y = pts_long[..., 1].clamp(0, h - 1)
    return torch.gather(depth.reshape(depth.shape[0], -1), 1,
                        (y * w + x).long())


def warp_kpts(kpts0: torch.Tensor, depth0: torch.Tensor, depth1: torch.Tensor,
              T_0to1: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp kpts0 from image0 to image1 via depth unprojection and the rigid
    transform.

    kpts0: [B, L, 2] (x, y) pixels; depth0/1: [B, H, W]; T_0to1: [B, 4, 4] or
    [B, 3, 4]; K0/K1: [B, 3, 3].  Returns (valid_mask [B, L], w_kpts0
    [B, L, 2]).  Valid = nonzero source depth & covisible & relative depth
    error < 0.2; a zero target depth (a depth hole) is invalid."""
    kpts0_long = torch.round(kpts0).to(torch.int32)
    kpts0_depth = _sample_depth(depth0, kpts0_long)            # [B, L]
    nonzero = kpts0_depth != 0

    ones = torch.ones_like(kpts0[..., :1])
    kpts0_h = torch.cat([kpts0, ones], dim=-1) * kpts0_depth[..., None]
    kpts0_cam = torch.linalg.inv(K0) @ kpts0_h.transpose(1, 2)  # [B, 3, L]

    w_cam = T_0to1[:, :3, :3] @ kpts0_cam + T_0to1[:, :3, 3:4]   # [B, 3, L]
    w_depth_computed = w_cam[:, 2, :]
    w_h = (K1 @ w_cam).transpose(1, 2)                           # [B, L, 3]
    w_kpts0 = w_h[..., :2] / (w_h[..., 2:3] + 1e-4)

    h, w = depth1.shape[1:3]
    covis = ((w_kpts0[..., 0] > 0) & (w_kpts0[..., 0] < w - 1)
             & (w_kpts0[..., 1] > 0) & (w_kpts0[..., 1] < h - 1))
    w_long = torch.where(covis[..., None], w_kpts0.to(torch.int32),
                         torch.zeros((), dtype=torch.int32,
                                     device=kpts0.device))
    w_depth = _sample_depth(depth1, w_long)
    # a zero target depth divides by itself in the reference (inf/nan, which
    # fails the < 0.2 check): keep it invalid rather than substitute
    consistent = (w_depth != 0) & (
        ((w_depth - w_depth_computed)
         / torch.where(w_depth == 0, torch.ones_like(w_depth),
                       w_depth)).abs() < 0.2)
    return nonzero & covis & consistent, w_kpts0
