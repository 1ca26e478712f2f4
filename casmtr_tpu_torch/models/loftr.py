"""Level padding masks (counterpart of ``level_mask`` in
casmtr_tpu/models/loftr.py; the QuadtreeLoFTR assembly is not ported yet,
ROADMAP queue A)."""

from __future__ import annotations

from typing import Optional

import torch

from casmtr_tpu_torch.ops.image_ops import resize_nearest


def level_mask(mask_full: Optional[torch.Tensor], h: int, w: int):
    """Nearest-downsample a full-resolution padding mask [B, H, W] to a level
    grid.  Returns ([B, h*w] float, [B, h, w] float), or (None, None)."""
    if mask_full is None:
        return None, None
    m = resize_nearest(mask_full.float(), h, w)
    return m.reshape(m.shape[0], -1), m
