"""CasMTR training loss (counterpart of casmtr_tpu/train/loss.py): focal or
cross-entropy on the coarse dual-softmax confidences, the per-level window
label loss (and the keypoint detector's, where a level has one), and the
fine sub-pixel l2(-with-std) loss, as masked means over the fixed-capacity
buffers."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from casmtr_tpu_torch.config import LoftrConfig
from casmtr_tpu_torch.parallel import mesh
from casmtr_tpu_torch.structs import MatchOutput


def _masked_mean(x, sel, w=None):
    """``(x * w)[sel].mean()``: the optional weight scales the numerator
    only, so weighted-out elements still count in the denominator.  Inside
    ``parallel.mesh.global_batch()`` the count is the global batch's
    (all-reduced, detached) and the numerator this rank's: the ranks'
    results sum to the mean over the global batch."""
    denom = sel.sum().to(x.dtype)
    grp = mesh.batch_group()
    if grp is not None:
        denom = mesh.all_reduce_sum(denom.detach()[None], grp)[0]
    denom = denom.clamp(min=1.0)
    xw = x * sel if w is None else x * sel * w
    return xw.sum() / denom


def coarse_loss(conf, conf_gt, loss_cfg, sparse_spvs: bool,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Focal or cross-entropy loss on the dual-softmax confidences.
    conf/conf_gt: [B, L0, L1]."""
    pos = conf_gt == 1
    neg = conf_gt == 0
    conf = conf.clamp(1e-6, 1 - 1e-6)
    if loss_cfg.coarse_type == "cross_entropy":
        lp = -torch.log(conf)
        ln = -torch.log(1 - conf)
        return (loss_cfg.pos_weight * _masked_mean(lp, pos, weight)
                + loss_cfg.neg_weight * _masked_mean(ln, neg, weight))
    if loss_cfg.coarse_type == "focal":
        a, g = loss_cfg.focal_alpha, loss_cfg.focal_gamma
        lp = -a * (1 - conf) ** g * torch.log(conf)
        if sparse_spvs:
            # no dustbin for dual_softmax: positives only
            return loss_cfg.pos_weight * _masked_mean(lp, pos, weight)
        ln = -a * conf ** g * torch.log(1 - conf)
        return (loss_cfg.pos_weight * _masked_mean(lp, pos, weight)
                + loss_cfg.neg_weight * _masked_mean(ln, neg, weight))
    raise ValueError(loss_cfg.coarse_type)


def cascade_loss(window_conf, window_gt, valid, loss_cfg) -> torch.Tensor:
    """Per-level window-label loss.  window_conf/window_gt: [M, Kw]; valid:
    [M] selection mask."""
    conf = window_conf.clamp(1e-6, 1 - 1e-6)
    pos = (window_gt == 1) & valid[:, None]
    neg = (window_gt == 0) & valid[:, None]
    a, g = loss_cfg.focal_alpha, loss_cfg.focal_gamma
    if loss_cfg.cascade_type == "binary_cross_entropy":
        return (loss_cfg.pos_weight * _masked_mean(-torch.log(conf), pos)
                + loss_cfg.neg_weight * _masked_mean(-torch.log(1 - conf),
                                                     neg))
    if loss_cfg.cascade_type == "cross_entropy":
        return loss_cfg.pos_weight * _masked_mean(-a * torch.log(conf), pos)
    if loss_cfg.cascade_type == "focal":
        lp = -a * (1 - conf) ** g * torch.log(conf)
        ln = -a * conf ** g * torch.log(1 - conf)
        return (loss_cfg.pos_weight * _masked_mean(lp, pos)
                + loss_cfg.neg_weight * _masked_mean(ln, neg))
    raise ValueError(loss_cfg.cascade_type)


def fine_loss(expec_f, expec_f_gt, valid, loss_cfg) -> torch.Tensor:
    """l2 or l2_with_std sub-pixel offset loss.  expec_f: [M, 3];
    expec_f_gt: [M, 2]; valid: [M]."""
    # rows with a non-finite gt drop out: NaN/inf comparisons are False
    correct = ((expec_f_gt.abs().amax(dim=1) < loss_cfg.fine_correct_thr)
               & valid)
    gt = torch.where(correct[:, None], torch.nan_to_num(expec_f_gt), 0.0)
    l2 = ((gt - expec_f[:, :2]) ** 2).sum(-1)
    if loss_cfg.fine_type == "l2":
        return _masked_mean(l2, correct)
    # inverse-std weights normalized over the valid rows, then detached; a
    # unit normalizer when no row is valid keeps the gradients finite (the
    # loss is 0 then)
    inv = 1.0 / expec_f[:, 2].clamp(min=1e-10)
    denom = _masked_mean(inv, valid)
    grp = mesh.batch_group()
    if grp is not None:   # the ranks' shares of the global mean, summed
        denom = mesh.all_reduce_sum(denom.detach()[None], grp)[0]
    w = (inv / torch.where(denom > 0, denom, torch.ones_like(denom))).detach()
    return _masked_mean(l2 * w, correct)


def casmtr_loss(out: MatchOutput, gt: Dict, expec_f_gt, cfg: LoftrConfig,
                c_weight: Optional[torch.Tensor] = None,
                opt_coarse: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Total loss and its named terms.  c_weight: optional [B, L0, L1]
    padding-mask weight of the coarse term."""
    lc = cfg.loss
    scalars = {}
    loss = 0.0
    if opt_coarse:
        l8 = coarse_loss(out.coarse.conf_matrix, gt["conf_matrix_gt_8c"], lc,
                         cfg.match_coarse.sparse_spvs, weight=c_weight)
        l8 = l8 * lc.coarse_weight
        loss = loss + l8
        scalars["loss_8c"] = l8

    for level_key, st in out.cascades.items():
        if st.window_gt_label is None:
            continue
        lcas = cascade_loss(st.window_conf, st.window_gt_label,
                            st.matches.valid, lc) * lc.cascade_weight
        loss = loss + lcas
        scalars[f"loss_{level_key}"] = lcas
        if st.detector_gt_label is not None:
            ldet = cascade_loss(st.detector_conf, st.detector_gt_label,
                                st.detector_valid, lc) * lc.detector_weight
            loss = loss + ldet
            scalars[f"loss_{level_key}_det"] = ldet

    if out.fine is not None and expec_f_gt is not None:
        last = list(out.cascades.values())[-1] if out.cascades else out.coarse
        lf = fine_loss(out.fine.expec_f, expec_f_gt, last.matches.valid, lc)
        lf = lf * lc.fine_weight
        loss = loss + lf
        scalars["loss_f"] = lf

    scalars["loss"] = loss
    return loss, scalars
