"""Ground truth by depth and pose warping (counterpart of
casmtr_tpu/train/supervision.py).

``compute_supervision`` runs BEFORE the model's forward: the training-time
cascade extraction consumes its ``gt_idx_*`` / ``gt_mask_*``.  Shapes are
fixed, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch

from casmtr_tpu_torch.config import LoftrConfig
from casmtr_tpu_torch.ops.geometry import warp_kpts
from casmtr_tpu_torch.ops.image_ops import resize_nearest


def _grid_pts(b: int, h: int, w: int, device) -> torch.Tensor:
    """[B, h*w, 2] (x, y) grid coordinates, float32."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    g = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    return g[None].expand(b, h * w, 2)


def _level_grid_warp(batch: Dict, scale: int):
    """Warp the level grid in both directions.  Returns (nearest_index1
    [B, L0] int32, correct_0to1 [B, L0] bool, w_pt0_i [B, L0, 2], grid_pt1_i
    [B, L1, 2], (h0, w0, h1, w1))."""
    img0, img1 = batch["image0"], batch["image1"]
    B, H0, W0 = img0.shape[:3]
    H1, W1 = img1.shape[1:3]
    h0, w0, h1, w1 = H0 // scale, W0 // scale, H1 // scale, W1 // scale
    dev = img0.device

    if "scale0" in batch:
        scale0 = scale * batch["scale0"][:, None]   # [B, 1, 2]
        scale1 = scale * batch["scale1"][:, None]
    else:
        scale0 = scale1 = float(scale)

    grid_pt0_i = _grid_pts(B, h0, w0, dev) * scale0
    grid_pt1_i = _grid_pts(B, h1, w1, dev) * scale1

    if "mask0" in batch:
        m0 = resize_nearest(batch["mask0"].float(), h0, w0).reshape(B, -1) > 0
        m1 = resize_nearest(batch["mask1"].float(), h1, w1).reshape(B, -1) > 0
        grid_pt0_i = torch.where(m0[..., None], grid_pt0_i, 0.0)
        grid_pt1_i = torch.where(m1[..., None], grid_pt1_i, 0.0)

    _, w_pt0_i = warp_kpts(grid_pt0_i, batch["depth0"], batch["depth1"],
                           batch["T_0to1"], batch["K0"], batch["K1"])
    _, w_pt1_i = warp_kpts(grid_pt1_i, batch["depth1"], batch["depth0"],
                           batch["T_1to0"], batch["K1"], batch["K0"])
    w_pt0_c = w_pt0_i / scale1
    w_pt1_c = w_pt1_i / scale0

    w0r = torch.round(w_pt0_c).to(torch.int32)
    nearest_index1 = w0r[..., 0] + w0r[..., 1] * w1
    w1r = torch.round(w_pt1_c).to(torch.int32)
    nearest_index0 = w1r[..., 0] + w1r[..., 1] * w0

    def oob(pt, w_, h_):
        return ((pt[..., 0] < 0) | (pt[..., 0] >= w_)
                | (pt[..., 1] < 0) | (pt[..., 1] >= h_))

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    nearest_index1 = torch.where(oob(w0r, w1, h1), zero, nearest_index1)
    nearest_index0 = torch.where(oob(w1r, w0, h0), zero, nearest_index0)

    loop_back = torch.gather(nearest_index0, 1, nearest_index1.long())
    correct = loop_back == torch.arange(h0 * w0, device=dev)[None]
    correct[:, 0] = False  # ignore the 0-depth sink cell
    return nearest_index1, correct, w_pt0_i, grid_pt1_i, (h0, w0, h1, w1)


def compute_supervision(batch: Dict, cfg: LoftrConfig
                        ) -> Dict[str, torch.Tensor]:
    """Ground truth of every level: conf_matrix_gt_8c [B, L0, L1] (the
    coarsest level), gt_idx_{level}c / gt_mask_{level}c per cascade level,
    and spv_w_pt0_i / spv_pt1_i of the last level (fine supervision)."""
    out = {}
    n1, correct, w_pt0_i, pt1_i, (h0, w0, h1, w1) = _level_grid_warp(
        batch, cfg.coarse_level)
    conf_gt = torch.zeros((n1.shape[0], h0 * w0, h1 * w1),
                          device=n1.device)
    conf_gt.scatter_(2, n1.long()[..., None], correct.float()[..., None])
    out["conf_matrix_gt_8c"] = conf_gt

    if cfg.cascade:
        for level in cfg.cascade_levels:
            n1l, correctl, w_pt0, pt1, _ = _level_grid_warp(batch, level)
            out[f"gt_idx_{level}c"] = n1l
            out[f"gt_mask_{level}c"] = correctl
            out["spv_w_pt0_i"] = w_pt0
            out["spv_pt1_i"] = pt1
    else:
        out["spv_w_pt0_i"] = w_pt0_i
        out["spv_pt1_i"] = pt1_i
    return out


def fine_expec_gt(gt: Dict, matches, batch: Dict, cfg: LoftrConfig
                  ) -> torch.Tensor:
    """Fine-level ground-truth offsets [M, 2] of the selected matches,
    normalized by the window radius at the fine level."""
    scale = cfg.fine_level if cfg.cascade else cfg.resolution[1]
    radius = cfg.fine_window_size // 2
    b, i, j = matches.b_ids, matches.i_ids, matches.j_ids
    sc = scale * batch["scale1"][b] if "scale1" in batch else float(scale)
    return (gt["spv_w_pt0_i"][b, i] - gt["spv_pt1_i"][b, j]) / sc / radius
