"""Cascade-level windowed softmax matching (counterpart of
casmtr_tpu/ops/cascade_matching.py): the eval filtering chain, and the
training-time thresholding and ground-truth window labels.

The window scores of the structured candidate set go through CUDA kernel B
on the card, and their gradient through kernel B-bwd
(ops/kernels/window_kernels.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from casmtr_tpu_torch.ops import nms
from casmtr_tpu_torch.ops.image_ops import resize_nearest
from casmtr_tpu_torch.ops.kernels.window_kernels import window_patch_score
from casmtr_tpu_torch.ops.matching import (grid_to_pixels, select_topm,
                                           valid_extent)
from casmtr_tpu_torch.ops.quadtree import block_children, unblock_children
from casmtr_tpu_torch.structs import Matches

INF = 1e9


class WindowSoftmaxResult(NamedTuple):
    conf01: torch.Tensor         # [B, L0, Kw]
    conf10: torch.Tensor         # [B, L1, Kw]
    next_idx_c01: torch.Tensor   # [B, L0] global idx into L1
    next_idx_c10: torch.Tensor   # [B, L1]
    next_conf_c01: torch.Tensor
    next_conf_c10: torch.Tensor


def _structured_score(f0, f1, corners, hw0, hw1, prop_w: int):
    """Window scores [B, L0, 4w^2]: queries 2x2-blocked per parent,
    candidates the (2w x 2w) patch of f1 at the parent's corner."""
    B, L0, C = f0.shape
    h0, w0 = hw0
    h1, w1 = hw1
    q_blk = block_children(f0, h0, w0).contiguous()      # [B, P, 4, C]
    f1_2d = f1.reshape(B, h1, w1, C).contiguous()
    s = window_patch_score(q_blk, f1_2d,
                           corners.to(torch.int32).contiguous(), prop_w)
    return unblock_children(s, h0 // 2, w0 // 2)


def window_softmax_matching(feat0, feat1, idx_c01, idx_c10, temperature: float,
                            mask0=None, mask1=None, corners0=None,
                            corners1=None, hw0=None, hw1=None,
                            prop_window: int = 0) -> WindowSoftmaxResult:
    """Window-restricted softmax in both directions over the structured
    candidate windows; the 1->0 direction carries no gradient.  feat0:
    [B, L0, C]; feat1: [B, L1, C]; idx_c01: [B, L0, Kw]; mask0/1: [B, L]
    flat padding masks."""
    if corners0 is None or prop_window <= 0:
        raise NotImplementedError(
            "window_softmax_matching: only the structured window candidates "
            "are ported (ROADMAP queue A: the 2c recipe)")
    c = feat0.shape[-1]
    f0 = feat0.float() / (c ** 0.5)
    f1 = feat1.float() / (c ** 0.5)

    def masked(sim, mask_q, mask_t, idx):
        if mask_q is None or mask_t is None:
            return sim
        B = idx.shape[0]
        wm = torch.gather(mask_t, 1, idx.reshape(B, -1)).reshape(idx.shape)
        return sim.masked_fill(~((wm * mask_q[:, :, None]) > 0), -INF)

    sim01 = _structured_score(f0, f1, corners0, hw0, hw1, prop_window)
    sim01 = masked(sim01 / temperature, mask0, mask1, idx_c01)
    conf01 = torch.softmax(sim01, dim=2)
    with torch.no_grad():
        sim10 = _structured_score(f1, f0, corners1, hw1, hw0, prop_window)
    sim10 = masked(sim10 / temperature, mask1, mask0, idx_c10)
    conf10 = torch.softmax(sim10, dim=2)

    next_conf01, local01 = conf01.max(dim=2)
    next_conf10, local10 = conf10.max(dim=2)
    next_idx01 = torch.gather(idx_c01, 2, local01[..., None])[..., 0]
    next_idx10 = torch.gather(idx_c10, 2, local10[..., None])[..., 0]
    return WindowSoftmaxResult(conf01, conf10, next_idx01, next_idx10,
                               next_conf01, next_conf10)


def window_border_ok(next_idx_c01, hw0, hw1, bd: int, mask0_2d=None,
                     mask1_2d=None) -> torch.Tensor:
    """Border validity of (source position, matched target position): near
    borders always, far borders at the valid extent when masks exist; the
    target test is strict (x < b or x > W1 - b)."""
    B, L0 = next_idx_c01.shape
    h0, w0 = hw0
    h1, w1 = hw1
    if bd <= 0:
        return torch.ones((B, L0), dtype=torch.bool,
                          device=next_idx_c01.device)
    i = torch.arange(L0, device=next_idx_c01.device)
    r0 = (i // w0)[None]
    c0 = (i % w0)[None]
    ty = torch.div(next_idx_c01, w1, rounding_mode="floor")
    tx = next_idx_c01 % w1
    ok = (r0 >= bd) & (c0 >= bd)
    if mask0_2d is not None:
        h0s, w0s = valid_extent(mask0_2d)
        h1s, w1s = valid_extent(mask1_2d)
        ok = ok & (r0 < h0s[:, None] - bd) & (c0 < w0s[:, None] - bd)
        ok = ok & ~((tx < bd) | (tx > w1s[:, None] - bd)
                    | (ty < bd) | (ty > h1s[:, None] - bd))
    else:
        ok = ok & (r0 < h0 - bd) & (c0 < w0 - bd)
        ok = ok & ~((tx < bd) | (tx > w1 - bd) | (ty < bd) | (ty > h1 - bd))
    return ok


def upscale_per_position(field: torch.Tensor, hw_src, hw_dst) -> torch.Tensor:
    """[B, L_src] -> [B, L_dst] nearest upsampling of a per-position field."""
    B = field.shape[0]
    f = field.reshape(B, hw_src[0], hw_src[1]).float()
    return resize_nearest(f, hw_dst[0], hw_dst[1]).reshape(B, -1)


def keep_at_least_one(mask: torch.Tensor) -> torch.Tensor:
    """If the whole batch filtered to nothing, force-keep position 0 of every
    row (guards the empty fine stage downstream)."""
    out = mask.clone()
    out[:, 0] |= ~mask.any()
    return out


def cascade_match_mask_test(
        ws: WindowSoftmaxResult, hw0, hw1, test_thr: float, bd: int,
        pre_confs: Sequence[torch.Tensor], pre_hws: Sequence[Tuple[int, int]],
        pre_thrs: Sequence[float], post_method: Optional[str],
        post_window: Optional[int], double_check: bool = True,
        mask0_2d=None, mask1_2d=None) -> torch.Tensor:
    """Test-time filtering chain: post-process, previous-stage confidence
    gates, border mask, cycle double-check, keep-at-least-one."""
    mask = nms.post_process_mask(post_method, ws.next_conf_c01, hw0, test_thr,
                                 window=post_window)
    for pre_conf, pre_hw, pre_thr in zip(pre_confs, pre_hws, pre_thrs):
        mask &= upscale_per_position(pre_conf, pre_hw, hw0) > pre_thr
    return _mask_common_tail(ws, mask, hw0, hw1, bd, double_check, mask0_2d,
                             mask1_2d)


def _mask_common_tail(ws, mask, hw0, hw1, bd, double_check, mask0_2d,
                      mask1_2d):
    """Border mask + cycle double-check + keep-at-least-one, shared by the
    train and test branches."""
    mask = mask & window_border_ok(ws.next_idx_c01, hw0, hw1, bd, mask0_2d,
                                   mask1_2d)
    if double_check:
        L0 = ws.next_idx_c01.shape[1]
        back = torch.gather(ws.next_idx_c10, 1, ws.next_idx_c01)
        mask &= back == torch.arange(L0, device=back.device)[None]
    return keep_at_least_one(mask)


def cascade_match_mask_train(ws: WindowSoftmaxResult, thr: float,
                             n_cands: int, hw0=None, hw1=None, bd: int = 0,
                             double_check: bool = False, mask0_2d=None,
                             mask1_2d=None) -> torch.Tensor:
    """Training-time thresholding: confidences above uniform (1/Kw) when
    thr > 0, else above thr, then the test path's border / double-check /
    keep-one tail."""
    if thr > 0:
        mask = ws.next_conf_c01 > (1.0 / n_cands)
    else:
        mask = ws.next_conf_c01 > thr
    if hw0 is None:
        return keep_at_least_one(mask)
    return _mask_common_tail(ws, mask, hw0, hw1, bd, double_check, mask0_2d,
                             mask1_2d)


def extract_cascade_matches(ws: WindowSoftmaxResult, mask: torch.Tensor,
                            hw0, hw1, m_cap: int, scale: float,
                            scale0=None, scale1=None,
                            priority: Optional[torch.Tensor] = None,
                            idx_c01: Optional[torch.Tensor] = None,
                            gt_idx_c01: Optional[torch.Tensor] = None,
                            gt_mask_c01: Optional[torch.Tensor] = None):
    """Fixed-capacity extraction ordered by ``priority`` (default: the
    confidence).  Returns (matches, extras).

    In training (``gt_idx_c01`` given) only positions whose ground-truth
    target lies inside the candidate window are selected, and ``extras``
    holds the selected rows' one-hot window labels ``window_gt_label``
    [M, Kw] and window confidences ``window_conf`` [M, Kw]."""
    B, L0 = ws.next_conf_c01.shape
    window_gt = None
    if gt_idx_c01 is not None:
        window_gt = (gt_idx_c01[..., None] == idx_c01) & gt_mask_c01[..., None]
        mask = mask & (window_gt.sum(-1) == 1)
    prio = ws.next_conf_c01 if priority is None else priority
    sel, valid = select_topm(mask.reshape(-1), prio.reshape(-1), m_cap)
    b_ids = torch.div(sel, L0, rounding_mode="floor")
    i_ids = sel % L0
    j_ids = ws.next_idx_c01.reshape(-1)[sel]
    mconf = torch.where(valid, ws.next_conf_c01.reshape(-1)[sel],
                        torch.zeros((), device=sel.device))
    s0 = scale0[b_ids] if scale0 is not None else None
    s1 = scale1[b_ids] if scale1 is not None else None
    matches = Matches(b_ids=b_ids, i_ids=i_ids, j_ids=j_ids, mconf=mconf,
                      valid=valid,
                      mkpts0=grid_to_pixels(i_ids, hw0[1], scale, s0),
                      mkpts1=grid_to_pixels(j_ids, hw1[1], scale, s1))
    extras = {}
    if window_gt is not None:
        Kw = idx_c01.shape[-1]
        extras["window_gt_label"] = window_gt.reshape(-1, Kw)[sel]
        extras["window_conf"] = ws.conf01.reshape(-1, Kw)[sel]
    return matches, extras
