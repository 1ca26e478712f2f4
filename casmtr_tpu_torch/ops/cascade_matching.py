"""Cascade-level windowed softmax matching (counterpart of
casmtr_tpu/ops/cascade_matching.py): the eval filtering chain, the
training-time thresholding and ground-truth window labels, and the
keypoint-detector branch's selection and labels.

The window scores of the structured candidate set go through CUDA kernel B
on the card, and their gradient through kernel B-bwd
(ops/kernels/window_kernels.py); other candidate sets (the dilated
propagation's) take the JAX package's gather path, in plain PyTorch on
every device, as the JAX package has no kernel for it either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from casmtr_tpu_torch.ops import kernels, nms
from casmtr_tpu_torch.ops.image_ops import resize_nearest
from casmtr_tpu_torch.ops.kernels.window_kernels import window_patch_score
from casmtr_tpu_torch.ops.matching import (grid_to_pixels, select_topm,
                                           valid_extent)
from casmtr_tpu_torch.ops.quadtree import block_children, unblock_children
from casmtr_tpu_torch.parallel import mesh
from casmtr_tpu_torch.structs import Matches

INF = 1e9


class WindowSoftmaxResult(NamedTuple):
    conf01: torch.Tensor         # [B, L0, Kw]
    conf10: torch.Tensor         # [B, L1, Kw]
    next_idx_c01: torch.Tensor   # [B, L0] global idx into L1
    next_idx_c10: torch.Tensor   # [B, L1]
    next_conf_c01: torch.Tensor
    next_conf_c10: torch.Tensor
    # [B, L0]: the largest masked score of each query before its softmax,
    # the detector branch's heatmap when it has no learnable head
    max_sim_c01: Optional[torch.Tensor] = None
    # the window softmax's second best and its global index into L1, for
    # the rt test gate (None unless asked for)
    next_conf_c01_s: Optional[torch.Tensor] = None  # [B, L0]
    next_idx_c01_s: Optional[torch.Tensor] = None   # [B, L0]


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


# the gather path's window scores take at most this many bytes of gathered
# target rows at a time
SCORE_CHUNK_BYTES = 1 << 28


def _gathered_score(f0, f1, idx):
    """s[b, l, k] = <f0[b, l], f1[b, idx[b, l, k]]> for a chunk of
    candidates, under the clipped-gather rule."""
    B = f0.shape[0]
    bi = torch.arange(B, device=f0.device)[:, None, None]
    rows = f1[bi, kernels.clip_index(idx.long(), f1.shape[1])]
    return torch.einsum("blc,blkc->blk", f0, rows)


def window_score(f0, f1, idx):
    """The JAX package's gather path of the window scores
    (``gather_ops.window_score``), in plain PyTorch on every device:
    scores [B, L0, K] of f0 [B, L0, C] against the rows ``idx`` [B, L0, K]
    of f1 [B, L1, C].  The gathered rows [B, L0, K, C] would be gigabytes
    on a dilated window at full size (81 x 4 candidates), so they are taken
    in chunks of candidates, and in training each chunk is gathered again
    for the backward instead of kept (the JAX package checkpoints the same
    gather)."""
    B, L0, C = f0.shape
    step = max(1, SCORE_CHUNK_BYTES // (B * L0 * C * f0.element_size()))
    grad = torch.is_grad_enabled() and (f0.requires_grad or f1.requires_grad)
    out = []
    for i in range(0, idx.shape[2], step):
        part = idx[:, :, i:i + step]
        out.append(checkpoint(_gathered_score, f0, f1, part,
                              use_reentrant=False) if grad
                   else _gathered_score(f0, f1, part))
    return torch.cat(out, dim=2)


def window_softmax_matching(feat0, feat1, idx_c01, idx_c10, temperature: float,
                            mask0=None, mask1=None, corners0=None,
                            corners1=None, hw0=None, hw1=None,
                            prop_window: int = 0,
                            track_second: bool = False) -> WindowSoftmaxResult:
    """Window-restricted softmax in both directions; the 1->0 direction
    carries no gradient.  feat0: [B, L0, C]; feat1: [B, L1, C]; idx_c01:
    [B, L0, Kw]; mask0/1: [B, L] flat padding masks.  With the structured
    windows' ``corners`` and ``prop_window`` the scores go through kernel
    B, else through the gather path (``window_score``).  ``track_second``
    also records each query's second largest window softmax and its global
    index (the best candidate knocked out; ties to the first candidate)."""
    c = feat0.shape[-1]
    f0 = feat0.float() / (c ** 0.5)
    f1 = feat1.float() / (c ** 0.5)

    def masked(sim, mask_q, mask_t, idx):
        if mask_q is None or mask_t is None:
            return sim
        B = idx.shape[0]
        wm = torch.gather(mask_t, 1, idx.reshape(B, -1)).reshape(idx.shape)
        return sim.masked_fill(~((wm * mask_q[:, :, None]) > 0), -INF)

    def score(fq, ft, corners, hw_q, hw_t, idx):
        if corners is None or prop_window <= 0:
            return window_score(fq, ft, idx)
        return _structured_score(fq, ft, corners, hw_q, hw_t, prop_window)

    sim01 = score(f0, f1, corners0, hw0, hw1, idx_c01)
    sim01 = masked(sim01 / temperature, mask0, mask1, idx_c01)
    conf01 = torch.softmax(sim01, dim=2)
    with torch.no_grad():
        sim10 = score(f1, f0, corners1, hw1, hw0, idx_c10)
    sim10 = masked(sim10 / temperature, mask1, mask0, idx_c10)
    conf10 = torch.softmax(sim10, dim=2)

    next_conf01, local01 = conf01.max(dim=2)
    next_conf10, local10 = conf10.max(dim=2)
    next_idx01 = torch.gather(idx_c01, 2, local01[..., None])[..., 0]
    next_idx10 = torch.gather(idx_c10, 2, local10[..., None])[..., 0]
    second = (None, None)
    if track_second:
        conf_s, local_s = conf01.scatter(2, local01[..., None], -1.0).max(2)
        second = (conf_s,
                  torch.gather(idx_c01, 2, local_s[..., None])[..., 0])
    return WindowSoftmaxResult(conf01, conf10, next_idx01, next_idx10,
                               next_conf01, next_conf10,
                               sim01.amax(dim=2), *second)


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
    row (guards the empty fine stage downstream).  Inside
    ``parallel.mesh.global_batch()`` the batch is the group's global
    batch."""
    out = mask.clone()
    grp = mesh.batch_group()
    if grp is None:
        out[:, 0] |= ~mask.any()
    else:
        out[:, 0] |= mesh.all_reduce_sum(mask.any().long()[None], grp)[0] == 0
    return out


def cascade_match_mask_test(
        ws: WindowSoftmaxResult, hw0, hw1, test_thr: float, bd: int,
        pre_confs: Sequence[torch.Tensor], pre_hws: Sequence[Tuple[int, int]],
        pre_thrs: Sequence[float], post_method: Optional[str],
        post_window: Optional[int], post_topk: Optional[int] = None,
        double_check: bool = True, mask0_2d=None, mask1_2d=None,
        s_d2d=None, d2d_w=None,
        post_temperature: float = 1.0, post_stride: int = 1,
        rt: Optional[float] = None, rd: Optional[float] = None,
        pre_confs_s: Optional[Sequence[torch.Tensor]] = None,
        rd_coarse: Optional[Tuple[torch.Tensor, torch.Tensor,
                                  Tuple[int, int]]] = None,
        image0: Optional[torch.Tensor] = None,
        image0_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Test-time filtering chain: the post-process filter and threshold
    (``nms.post_process_mask``), the gates, the previous levels'
    confidences (nearest-upsampled), then border mask, cycle double-check
    and keep-at-least-one.

    ``rt`` drops a position whose second-best over best confidence exceeds
    it, at this level (``ws``'s second-best tracking) and at every previous
    level (``pre_confs_s`` beside ``pre_confs``).  ``rd`` drops it when the
    1/8 level's best and second-best targets lie more than ``rd`` apart in
    grid-normalized coordinates; ``rd_coarse`` is (its best and
    second-best target indices [B, L8], its grid).  The reference declares
    both gates and never computes their inputs; this is the JAX package's
    completion of them."""
    mask = nms.post_process_mask(post_method, ws.next_conf_c01, hw0, test_thr,
                                 window=post_window, topk=post_topk,
                                 s_d2d=s_d2d, d2d_w=d2d_w,
                                 temperature=post_temperature,
                                 stride=post_stride, image0=image0,
                                 image0_mask=image0_mask)
    if rt is not None:
        mask &= ~(ws.next_conf_c01_s / (ws.next_conf_c01 + 1e-7) > rt)
    for i, (pre_conf, pre_hw, pre_thr) in enumerate(
            zip(pre_confs, pre_hws, pre_thrs)):
        up = upscale_per_position(pre_conf, pre_hw, hw0)
        mask &= up > pre_thr
        if rt is not None:
            up_s = upscale_per_position(pre_confs_s[i], pre_hw, hw0)
            mask &= ~(up_s / (up + 1e-7) > rt)
    if rd is not None:
        idx8, idx8_s, (h8, w8) = rd_coarse
        x = (idx8 % w8).float() / w8
        y = torch.div(idx8, w8, rounding_mode="floor").float() / h8
        xs = (idx8_s % w8).float() / w8
        ys = torch.div(idx8_s, w8, rounding_mode="floor").float() / h8
        dist = torch.sqrt((x - xs) ** 2 + (y - ys) ** 2)
        mask &= ~(upscale_per_position(dist, (h8, w8), hw0) > rd)
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


def detect_keypoints(heatmap0, conf01, mode: str, grid_size: int,
                     uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grid-wise hard keypoint selection with a straight-through gradient:
    the heatmap [B, H, W] is cut into grid_size x grid_size cells, one
    position per cell is picked (the argmax of the cell's softmax, of the
    heatmap plus Gumbel noise in ``gumbel`` mode, of the heatmap alone in
    ``ST`` mode), and the rows of ``conf01`` [B, H*W, K] at the other
    positions are zeroed; the gradient passes through the soft selection.
    ``uniform`` [B, (H/g)*(W/g), g*g] in (0, 1] is the Gumbel mode's draw
    (the caller's generator; see train.train_step).  Returns
    [B, H*W, K]."""
    B, H, W = heatmap0.shape
    g = grid_size
    cells = heatmap0.reshape(B, H // g, g, W // g, g).transpose(2, 3)
    cells = cells.reshape(B, (H // g) * (W // g), g * g)
    if mode == "gumbel":
        if uniform is None:
            raise ValueError("the gumbel detector needs a uniform draw")
        logits = cells - torch.log(-torch.log(uniform + 1e-9))
    elif mode == "ST":
        logits = cells
    else:
        raise NotImplementedError(mode)
    soft = torch.softmax(logits, dim=-1)
    hard = torch.nn.functional.one_hot(soft.argmax(-1), g * g).to(soft.dtype)
    sel = hard - soft.detach() + soft
    sel = sel.reshape(B, H // g, W // g, g, g).transpose(2, 3)
    return conf01 * sel.reshape(B, H * W)[..., None]


def select_detector_labels(detector_matrix, base_mask, idx_c01, gt_idx_c01,
                           gt_mask_c01, m_cap: int):
    """Fixed-capacity selection of the detector branch's window labels:
    the positions whose detector confidence exceeds uniform (1/Kw), that
    pass the base training mask and whose ground truth lies inside their
    window, in order of that confidence.  Returns (labels [M, Kw] bool,
    confidences [M, Kw], valid [M])."""
    B, L0, Kw = detector_matrix.shape
    det_conf = detector_matrix.amax(dim=2)
    window_gt = (gt_idx_c01[..., None] == idx_c01) & gt_mask_c01[..., None]
    mask = (base_mask & (det_conf > 1.0 / Kw)
            & (window_gt.sum(-1) == 1))
    sel, valid = select_topm(mask.reshape(-1), det_conf.reshape(-1), m_cap)
    return (window_gt.reshape(-1, Kw)[sel],
            detector_matrix.reshape(-1, Kw)[sel], valid)
