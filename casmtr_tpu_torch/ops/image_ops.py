"""Image-grid helpers (counterpart of casmtr_tpu/ops/image_ops.py).

Layout is PyTorch's NCHW; the JAX package works on NHWC.  The sampling
rules are the same: bilinear with align_corners=True (the reference's
``F.interpolate`` calls), nearest with ``src = floor(dst * in / out)``, and
2x2 average pooling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int
                                  ) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] with align_corners=True sampling."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of [..., H, W] (src = floor(dst * in / out))."""
    h, w = x.shape[-2:]
    ys = torch.floor(torch.arange(out_h, device=x.device) * (h / out_h)).long()
    xs = torch.floor(torch.arange(out_w, device=x.device) * (w / out_w)).long()
    return x[..., ys, :][..., xs]


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pooling of [B, C, H, W] (the quadtree pyramid)."""
    return F.avg_pool2d(x, 2)
