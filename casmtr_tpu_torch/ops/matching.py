"""Coarse dual-softmax matching with fixed-capacity match extraction
(counterpart of casmtr_tpu/ops/matching.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from casmtr_tpu_torch.parallel import mesh
from casmtr_tpu_torch.structs import Matches

INF = 1e9


class DualSoftmaxResult(NamedTuple):
    conf_matrix: torch.Tensor    # [B, L0, L1]
    next_idx_c01: torch.Tensor   # [B, L0]
    next_idx_c10: torch.Tensor   # [B, L1]
    next_conf_c01: torch.Tensor  # [B, L0]
    next_conf_c10: torch.Tensor  # [B, L1]
    # the row softmax's second best and its column, for the cascade levels'
    # rt/rd test gates (None unless asked for)
    next_conf_c01_s: Optional[torch.Tensor] = None  # [B, L0]
    next_idx_c01_s: Optional[torch.Tensor] = None   # [B, L0]


def dual_softmax(feat0: torch.Tensor, feat1: torch.Tensor, temperature: float,
                 mask0: Optional[torch.Tensor] = None,
                 mask1: Optional[torch.Tensor] = None,
                 track_second: bool = False) -> DualSoftmaxResult:
    """Dual-softmax confidence.  feat0: [B, L0, C]; feat1: [B, L1, C];
    masks [B, L] (1 = valid).  Similarity of the sqrt(C)-scaled features,
    divided by ``temperature``.  ``track_second`` also records each row
    softmax's second largest value and its column (the best column knocked
    out; ties to the first column, as every argmax here)."""
    c = feat0.shape[-1]
    f0 = feat0.float() / (c ** 0.5)
    f1 = feat1.float() / (c ** 0.5)
    sim = torch.einsum("blc,bsc->bls", f0, f1) / temperature
    if mask0 is not None and mask1 is not None:
        valid = (mask0[:, :, None] * mask1[:, None, :]) > 0
        sim = sim.masked_fill(~valid, -INF)
    sm10 = torch.softmax(sim, dim=1)
    sm01 = torch.softmax(sim, dim=2)
    conf = sm10 * sm01
    next_conf_c01, next_idx_c01 = sm01.max(dim=2)
    next_conf_c10, next_idx_c10 = sm10.max(dim=1)
    second = (None, None)
    if track_second:
        # softmax values are >= 0, so the -1 never wins
        second = sm01.scatter(2, next_idx_c01[..., None], -1.0).max(dim=2)
    return DualSoftmaxResult(conf, next_idx_c01, next_idx_c10,
                             next_conf_c01, next_conf_c10, *second)


def _border_ok(rows, cols, bd, h, w, h_valid=None, w_valid=None):
    """Positions at least ``bd`` away from every border (the far border is the
    per-sample valid extent when padding masks exist)."""
    hh = h - bd if h_valid is None else h_valid - bd
    ww = w - bd if w_valid is None else w_valid - bd
    return (rows >= bd) & (cols >= bd) & (rows < hh) & (cols < ww)


def valid_extent(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample valid (h, w) from a padded-region mask [B, H, W]."""
    m = mask.long()
    return m.sum(dim=1).max(dim=-1).values, m.sum(dim=2).max(dim=-1).values


def select_topm(mask_flat: torch.Tensor, conf_flat: torch.Tensor, m_cap: int):
    """Top-``m_cap`` valid entries by confidence of flattened [N] arrays.
    Returns (indices [M], valid [M]); slots beyond N are invalid.

    Inside ``parallel.mesh.global_batch()`` the arrays are this rank's rows
    of a global batch: the selection is one top-``m_cap`` over every
    rank's scores gathered in rank order (the flattened global batch, with
    its ties), and each rank keeps the picks in its own rows, in their
    order, as local indices packed ahead of invalid slots."""
    score = torch.where(mask_flat, conf_flat,
                        torch.full_like(conf_flat, float("-inf")))
    grp = mesh.batch_group()
    if grp is None:
        return _top_scores(score, m_cap)
    n = score.shape[0]
    with torch.profiler.record_function("dp:select_gather"):
        everyone = mesh.all_gather_flat(score, grp)
    idx, valid = _top_scores(everyone, m_cap)
    lo = mesh.rank() * n
    mine = valid & (idx >= lo) & (idx < lo + n)
    order = torch.argsort((~mine).to(torch.uint8), stable=True)
    return torch.where(mine, idx - lo, 0)[order], mine[order]


def _top_scores(score: torch.Tensor, m_cap: int):
    """Top-``m_cap`` finite entries of ``score`` [N] (-inf: not a
    candidate): (indices [M], valid [M])."""
    n = score.shape[0]
    k = min(m_cap, n)
    vals, idx = torch.topk(score, k)
    valid = torch.isfinite(vals)
    if k < m_cap:
        idx = torch.cat([idx, idx.new_zeros(m_cap - k)])
        valid = torch.cat([valid, valid.new_zeros(m_cap - k)])
    return idx, valid


def grid_to_pixels(flat_idx, w, scale, scale_xy=None):
    """Flat grid index -> (x, y) pixels: grid stride ``scale`` in model
    pixels, then optional per-match [.., 2] resize factors."""
    pts = torch.stack([(flat_idx % w).float(),
                       torch.div(flat_idx, w, rounding_mode="floor").float()],
                      dim=-1) * scale
    if scale_xy is not None:
        pts = pts * scale_xy
    return pts


def extract_coarse_matches(
        conf_matrix: torch.Tensor, thr: float, border_rm: int,
        hw0: Tuple[int, int], hw1: Tuple[int, int], m_cap: int,
        scale: float, mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
        scale0: Optional[torch.Tensor] = None,
        scale1: Optional[torch.Tensor] = None) -> Matches:
    """Threshold + mutual nearest neighbour + padding and border removal,
    then fixed-capacity top-M selection ordered by confidence.

    conf_matrix: [B, L0, L1]; mask0/1: optional [B, h, w] padding masks at
    this level; scale0/1: optional [B, 2] original-image resize factors."""
    B, L0, L1 = conf_matrix.shape
    h0, w0 = hw0
    h1, w1 = hw1
    keep = conf_matrix > thr
    keep &= conf_matrix == conf_matrix.max(dim=2, keepdim=True).values
    keep &= conf_matrix == conf_matrix.max(dim=1, keepdim=True).values
    if mask0 is not None and mask1 is not None:
        keep &= mask0.reshape(B, L0)[:, :, None] > 0
        keep &= mask1.reshape(B, L1)[:, None, :] > 0
    if border_rm > 0:
        dev = conf_matrix.device
        i = torch.arange(L0, device=dev)[None]
        j = torch.arange(L1, device=dev)[None]
        if mask0 is not None:
            h0s, w0s = valid_extent(mask0)
            h1s, w1s = valid_extent(mask1)
            ok0 = _border_ok(i // w0, i % w0, border_rm, h0, w0,
                             h0s[:, None], w0s[:, None])
            ok1 = _border_ok(j // w1, j % w1, border_rm, h1, w1,
                             h1s[:, None], w1s[:, None])
        else:
            ok0 = _border_ok(i // w0, i % w0, border_rm, h0, w0)
            ok1 = _border_ok(j // w1, j % w1, border_rm, h1, w1)
        keep &= ok0[:, :, None] & ok1[:, None, :]

    mask_v = keep.any(dim=2)                                   # [B, L0]
    j_ids_row = keep.to(torch.uint8).argmax(dim=2)             # first True
    conf_row = torch.gather(conf_matrix, 2, j_ids_row[..., None])[..., 0]

    sel, valid = select_topm(mask_v.reshape(-1), conf_row.reshape(-1), m_cap)
    b_ids = torch.div(sel, L0, rounding_mode="floor")
    i_ids = sel % L0
    j_ids = j_ids_row.reshape(-1)[sel]
    mconf = torch.where(valid, conf_row.reshape(-1)[sel],
                        torch.zeros((), device=sel.device))
    s0 = scale0[b_ids] if scale0 is not None else None
    s1 = scale1[b_ids] if scale1 is not None else None
    return Matches(b_ids=b_ids, i_ids=i_ids, j_ids=j_ids, mconf=mconf,
                   valid=valid, mkpts0=grid_to_pixels(i_ids, w0, scale, s0),
                   mkpts1=grid_to_pixels(j_ids, w1, scale, s1))
