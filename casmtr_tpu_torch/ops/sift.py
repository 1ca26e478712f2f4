"""Scale-space blob keypoints for the 'sift' test-time filter (counterpart of
casmtr_tpu/ops/sift.py): keep the matches whose coarse cell holds a
keypoint of image0.

The JAX package's detector, not kornia's: a Gaussian pyramid of the image
doubled in size (3 levels per octave, sigma 1.6, octaves down to a short
side of 64), separable blurs from edge-replicated borders, the
scale-normalized Hessian determinant sigma^4 (Ixx Iyy - Ixy^2) from 3x3
zero-padded stencils as the response, a 3x3x3 (level, y, x) local-maximum
test whose neighbours wrap around the image edge (that border is then
suppressed), and a global top-4096 across octaves, ties to the lower index.
Only keypoint centres reach the mask, quantized to the coarse cells as the
reference does (its float flat-index quirk included).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from casmtr_tpu_torch.ops.quadtree import topk_lowest_first

# second-derivative stencils (rows: y, columns: x)
D_XX = ((0.0, 0.0, 0.0), (1.0, -2.0, 1.0), (0.0, 0.0, 0.0))
D_YY = ((0.0, 1.0, 0.0), (0.0, -2.0, 0.0), (0.0, 1.0, 0.0))
D_XY = ((0.25, 0.0, -0.25), (0.0, 0.0, 0.0), (-0.25, 0.0, 0.25))


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [B, H, W], rows then columns, each from
    the edge-replicated image (output the input's size)."""
    k = torch.from_numpy(_gaussian_kernel1d(sigma)).to(img.device)
    r = k.shape[0] // 2
    x = F.pad(img[:, None], (0, 0, r, r), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="replicate")
    return F.conv2d(x, k.reshape(1, 1, 1, -1))[:, 0]


def _hessian_det(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized Hessian determinant response of [B, H, W]."""
    kern = torch.tensor((D_XX, D_YY, D_XY), dtype=torch.float32,
                        device=img.device)[:, None]
    d = F.conv2d(img[:, None], kern, padding=1)              # [B, 3, H, W]
    return (sigma ** 4) * (d[:, 0] * d[:, 1] - d[:, 2] * d[:, 2])


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of [B, H, W] at half-pixel centres, the edge
    rows and columns repeating the border value (``jax.image.resize``
    bilinear, which renormalizes the weights that fall inside)."""
    return F.interpolate(img[:, None], scale_factor=2, mode="bilinear",
                         align_corners=False)[:, 0]


def octave_responses(img: torch.Tensor, sigmas) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """One octave's middle-level responses [B, L, H, W] and the largest of
    each one's 26 (level, y, x) neighbours, the y and x neighbours wrapping
    around the edges."""
    resp = torch.stack([_hessian_det(_blur(img, s), s) for s in sigmas], 1)
    mid = resp[:, 1:-1]
    neigh = torch.full_like(mid, float("-inf"))
    n = resp.shape[1]
    for dl in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == dy == dx == 0:
                    continue
                sl = torch.roll(resp[:, 1 + dl:n - 1 + dl], (dy, dx), (2, 3))
                neigh = torch.maximum(neigh, sl)
    return mid, neigh


def scale_space_keypoints(gray: torch.Tensor, max_kpts: int = 4096,
                          n_levels: int = 3, init_sigma: float = 1.6,
                          min_size: int = 64, double_image: bool = True,
                          resp_thr: float = 1e-5,
                          valid_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blob keypoints of [B, H, W] grayscale in [0, 1].

    Returns (kpts_xy [B, max_kpts, 2] float32 in the input's pixel
    coordinates, valid [B, max_kpts] bool), by response, largest first.
    ``valid_mask`` ([B, H, W] bool) suppresses responses in padded
    regions.  Raises ValueError when the image (doubled) is too small for
    one octave."""
    B = gray.shape[0]
    img = _upsample2(gray) if double_image else gray
    scale = 0.5 if double_image else 1.0
    vm = None
    if valid_mask is not None:
        vm = (_upsample2(valid_mask.float()) > 0.5 if double_image
              else valid_mask.bool())
    sigmas = [init_sigma * (2.0 ** (i / n_levels))
              for i in range(n_levels + 2)]
    flat: List[torch.Tensor] = []
    meta = []                                   # (scale, Ho, Wo) per octave
    while min(img.shape[1], img.shape[2]) >= min_size:
        Ho, Wo = img.shape[1], img.shape[2]
        mid, neigh = octave_responses(img, sigmas)
        keep = (mid > neigh) & (mid > resp_thr)
        border = torch.zeros((Ho, Wo), dtype=torch.bool, device=img.device)
        border[1:-1, 1:-1] = True
        keep &= border
        if vm is not None:
            keep &= vm[:, None]
        flat.append(torch.where(keep, mid, torch.full_like(mid, float("-inf"))
                                ).reshape(B, -1))
        meta.append((scale, Ho, Wo))
        img = img[:, ::2, ::2]
        if vm is not None:
            vm = vm[:, ::2, ::2]
        scale *= 2.0
    if not flat:
        raise ValueError(
            f"image {gray.shape[1]}x{gray.shape[2]} too small for the "
            f"scale pyramid (needs >= {min_size} px on the short side"
            f"{' after 2x doubling' if double_image else ''})")
    allr = torch.cat(flat, dim=1)
    k = min(max_kpts, allr.shape[1])
    vals, idx = topk_lowest_first(allr, k, dim=1)            # [B, k]
    xy = torch.zeros((B, k, 2), dtype=torch.float32, device=gray.device)
    off = 0
    for (s_o, Ho, Wo), r in zip(meta, flat):
        local = idx - off
        inside = (local >= 0) & (local < r.shape[1])
        yx = local % (Ho * Wo)
        pt = torch.stack([(yx % Wo).float() * s_o,
                          torch.div(yx, Wo, rounding_mode="floor").float()
                          * s_o], dim=-1)
        xy = torch.where(inside[..., None], pt, xy)
        off += r.shape[1]
    valid = torch.isfinite(vals) & (vals > resp_thr)
    if k < max_kpts:
        xy = F.pad(xy, (0, 0, 0, max_kpts - k))
        valid = F.pad(valid, (0, max_kpts - k))
    return xy, valid


def sift_cell_mask(image0: torch.Tensor, hw_c: Tuple[int, int], stride: int,
                   max_kpts: int = 4096,
                   valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, h0 * w0] bool: True where the stride-``stride`` coarse cell holds
    a keypoint of image0 ([B, H, W, 3] RGB or [B, H, W] gray).  As the
    reference, the float flat index y / stride * w0 + x / stride is clamped
    and rounded as a whole (a fractional row spills into the column)."""
    if image0.dim() == 4:
        gray = (0.299 * image0[..., 0] + 0.587 * image0[..., 1]
                + 0.114 * image0[..., 2])
    else:
        gray = image0
    h0, w0 = hw_c
    xy, valid = scale_space_keypoints(gray, max_kpts=max_kpts,
                                      valid_mask=valid_mask)
    flat = xy[..., 1] / stride * w0 + xy[..., 0] / stride
    cell = torch.round(flat.clamp(0, h0 * w0 - 1)).long()
    cell = torch.where(valid, cell, torch.full_like(cell, h0 * w0))
    mask = torch.zeros((gray.shape[0], h0 * w0 + 1), dtype=torch.bool,
                       device=gray.device)
    return mask.scatter_(1, cell, True)[:, :h0 * w0]
