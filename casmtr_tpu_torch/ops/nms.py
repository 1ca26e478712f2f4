"""Test-time keypoint filtering (counterpart of casmtr_tpu/ops/nms.py): the
filters a cascade level's ``post_config.method`` selects, each a keep mask
over the level's grid that is AND'd with the confidence threshold.

``maxpool_nms`` (the released recipes' default) keeps a position that is the
argmax of the window centred on it; ``local_window_nms`` the top-k of each
non-overlapping window; ``softargmax_nms`` the positions that a window's
softmax-expected position rounds to; ``d2d`` the most salient positions of
a feature-statistics map at 1/4 of the grid, as many as maxpool NMS keeps;
``sift`` the cells that hold a scale-space blob keypoint of image0
(ops/sift.py).  Ties go to the lower index wherever the JAX package's CPU
graph breaks them so (``lax.top_k``, a stable ``argsort``), on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from casmtr_tpu_torch.ops.quadtree import topk_lowest_first
from casmtr_tpu_torch.parallel import mesh


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


def local_window_nms_mask(conf: torch.Tensor, hw: Tuple[int, int],
                          window: int, topk: int) -> torch.Tensor:
    """[B, L] -> [B, L] bool: the ``topk`` largest of each non-overlapping
    window x window tile (the grid sides must be multiples of the window),
    ties to the lower index within the tile."""
    B = conf.shape[0]
    h, w = hw
    c = conf.reshape(B, h // window, window, w // window, window)
    c = c.transpose(2, 3).reshape(B, -1, window * window)
    _, top_i = topk_lowest_first(c, topk, dim=2)            # [B, nW, k]
    keep = torch.zeros_like(c, dtype=torch.bool).scatter_(2, top_i, True)
    keep = keep.reshape(B, h // window, w // window, window, window)
    return keep.transpose(2, 3).reshape(B, h * w)


def softargmax_nms_mask(conf: torch.Tensor, hw: Tuple[int, int], window: int,
                        temperature: float = 1.0, stride: int = 1
                        ) -> torch.Tensor:
    """[B, L] -> [B, L] bool: every window votes for its softmax-expected
    position, rounded half to even and clamped into the grid; a position is
    kept if a window voted for it.  ``stride`` 1 slides a centred window
    over the zero-padded grid (the zeros take part in the softmax);
    ``stride`` equal to ``window`` tiles the grid without padding and drops
    the partial tiles at the far borders.  The vote's flat index is
    y * w + x (the JAX package's reading of the reference)."""
    B = conf.shape[0]
    h, w = hw
    if stride not in (1, window):
        raise ValueError(f"softargmax_nms: stride {stride} must be 1 or the "
                         f"window {window}")
    c2 = conf.reshape(B, h, w)
    dev = conf.device
    if stride == 1:
        pad = window // 2
        cp = F.pad(c2, (pad, pad, pad, pad))
        v, sy, sx = [], [], []
        yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
        for dy in range(window):
            for dx in range(window):
                v.append(cp[:, dy:dy + h, dx:dx + w])
                sy.append(yy + (dy - pad))
                sx.append(xx + (dx - pad))
        p = torch.softmax(torch.stack(v, dim=-1) / temperature, dim=-1)
        ey = (p * torch.stack(sy, dim=-1)).sum(-1)           # [B, h, w]
        ex = (p * torch.stack(sx, dim=-1)).sum(-1)
    else:
        hT, wT = h // window, w // window
        c4 = c2[:, :hT * window, :wT * window]
        c4 = c4.reshape(B, hT, window, wT, window).transpose(2, 3)
        p = torch.softmax((c4 / temperature).reshape(B, hT, wT, -1), dim=-1
                          ).reshape(c4.shape)                # [B, hT, wT, k, k]
        off = torch.arange(window, dtype=torch.float32, device=dev)
        oy = torch.arange(hT, dtype=torch.float32, device=dev) * window
        ox = torch.arange(wT, dtype=torch.float32, device=dev) * window
        ey = torch.einsum("bhwyx,y->bhw", p, off) + oy[None, :, None]
        ex = torch.einsum("bhwyx,x->bhw", p, off) + ox[None, None, :]
    ty = torch.round(ey).clamp(0, h - 1).long()
    tx = torch.round(ex).clamp(0, w - 1).long()
    flat = (ty * w + tx).reshape(B, -1)                      # [B, n_windows]
    mask = torch.zeros((B, h * w), dtype=torch.bool, device=dev)
    return mask.scatter_(1, flat, True)


def d2d_saliency(feat0: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Feature-statistics saliency S_as * S_rs at 1/4 of the level grid.
    feat0: [B, L, C] normalized features.  S_as is each position's
    population standard deviation over channels, sampled every 4th row and
    column; S_rs the channel norm of a per-channel 5x5 centre-surround
    filter at stride 4 (zero padding 2), min-max normalized over the whole
    batch.  Returns [B, ceil(h/4) * ceil(w/4)]."""
    B, L, C = feat0.shape
    h, w = hw
    s_as = feat0.std(dim=-1, correction=0).reshape(B, h, w)[:, ::4, ::4]
    k = torch.full((5, 5), -1.0 / 25.0, device=feat0.device)
    k[2, 2] = 24.0
    resp = F.conv2d(feat0.transpose(1, 2).reshape(B, C, h, w),
                    k.expand(C, 1, 5, 5).contiguous(), stride=4, padding=2,
                    groups=C)
    s_rs = torch.linalg.vector_norm(resp, dim=1)             # [B, h/4, w/4]
    lo, hi = s_rs.min(), s_rs.max()
    grp = mesh.batch_group()
    if grp is not None:    # the global batch's range
        ends = mesh.all_gather_flat(torch.stack([lo, hi]), grp).view(-1, 2)
        lo, hi = ends[:, 0].min(), ends[:, 1].max()
    s_rs = (s_rs - lo) / (hi - lo + 1e-12)
    return (s_as * s_rs).reshape(B, -1)


def d2d_mask(conf: torch.Tensor, hw: Tuple[int, int], window: int,
             s_d2d: torch.Tensor, d2d_w: int) -> torch.Tensor:
    """[B, L] -> [B, L] bool: per image, as many of the most salient
    ``s_d2d`` positions as maxpool NMS keeps (a stable ranking: ties to the
    lower index), each placed on the level grid at (4 y, 4 x) of its
    position in the d2d_w-wide saliency grid; a placement outside the grid
    is dropped."""
    B, L = conf.shape
    num = maxpool_nms_mask(conf, hw, window).sum(dim=1)      # [B]
    order = torch.argsort(-s_d2d, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    sel = rank < num[:, None]                                # [B, n]
    pos = torch.arange(s_d2d.shape[1], device=conf.device)
    flat = torch.div(pos, d2d_w, rounding_mode="floor") * 4 * (d2d_w * 4) \
        + pos % d2d_w * 4
    inside = flat < L
    mask = torch.zeros((B, L), dtype=torch.bool, device=conf.device)
    mask[:, flat[inside]] = sel[:, inside]
    return mask


def post_process_mask(method: Optional[str], conf: torch.Tensor,
                      hw: Tuple[int, int], test_thr: float,
                      window: Optional[int] = None,
                      topk: Optional[int] = None,
                      s_d2d: Optional[torch.Tensor] = None,
                      d2d_w: Optional[int] = None,
                      temperature: float = 1.0,
                      stride: int = 1,
                      image0: Optional[torch.Tensor] = None,
                      image0_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """conf: [B, L] -> keep mask [B, L]: the filter ``method`` (None: the
    threshold alone) AND ``conf > test_thr``.  ``d2d`` takes its saliency
    ``s_d2d`` and that grid's width ``d2d_w`` (``d2d_saliency``); ``sift``
    the model's input image0 [B, H, W, 3] (or [B, H, W] gray) and its valid
    mask [B, H, W]."""
    if method is None:
        return conf > test_thr
    if method == "maxpool_nms":
        m = maxpool_nms_mask(conf, hw, window)
    elif method == "local_window_nms":
        m = local_window_nms_mask(conf, hw, window, topk)
    elif method == "softargmax_nms":
        m = softargmax_nms_mask(conf, hw, window, temperature, stride)
    elif method == "d2d":
        m = d2d_mask(conf, hw, window, s_d2d, d2d_w)
    elif method == "sift":
        if image0 is None:
            raise ValueError("post-process 'sift' needs image0 (the model "
                             "passes it when post_config.method == 'sift')")
        from casmtr_tpu_torch.ops.sift import sift_cell_mask
        m = sift_cell_mask(image0, hw, image0.shape[1] // hw[0],
                           valid_mask=image0_mask)
    else:
        raise NotImplementedError(f"post-process '{method}' not supported")
    return m & (conf > test_thr)
