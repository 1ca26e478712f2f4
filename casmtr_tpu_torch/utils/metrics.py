"""Evaluation metrics (counterpart of casmtr_tpu/utils/metrics.py, in numpy):
the symmetric epipolar distance of matches, the reference pose protocol
(``estimate_pose``: essential-matrix RANSAC and ``recoverPose`` per pair,
on the host), the relative pose error, and the pose AUC and epipolar
precision a dataset is scored by.

The JAX package's protocol calls OpenCV; the port runs its own solver and
no OpenCV (``casmtr_tpu_torch.sfm.essential``, which draws OpenCV's
samples and so gives its E and inliers).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np

from casmtr_tpu_torch.sfm.essential import find_essential, recover_pose

def cross_product_matrix(t: np.ndarray) -> np.ndarray:
    """[3] -> skew-symmetric [3, 3]."""
    return np.array([[0, -t[2], t[1]],
                     [t[2], 0, -t[0]],
                     [-t[1], t[0], 0]], dtype=t.dtype)


def symmetric_epipolar_distance(pts0, pts1, E, K0, K1) -> np.ndarray:
    """Squared symmetric epipolar distance in normalized coordinates of
    pixel matches pts0/pts1 [N, 2] under the essential matrix E."""
    pts0 = (pts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    pts1 = (pts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    p0 = np.concatenate([pts0, np.ones_like(pts0[:, :1])], -1)
    p1 = np.concatenate([pts1, np.ones_like(pts1[:, :1])], -1)
    Ep0 = p0 @ E.T
    p1Ep0 = np.sum(p1 * Ep0, -1)
    Etp1 = p1 @ E
    return p1Ep0 ** 2 * (1.0 / (Ep0[:, 0] ** 2 + Ep0[:, 1] ** 2 + 1e-12)
                         + 1.0 / (Etp1[:, 0] ** 2 + Etp1[:, 1] ** 2 + 1e-12))


def compute_epipolar_errors(mkpts0, mkpts1, T_0to1, K0, K1) -> np.ndarray:
    """Per-match epipolar error of one pair under its true pose T_0to1."""
    E = cross_product_matrix(T_0to1[:3, 3]) @ T_0to1[:3, :3]
    return symmetric_epipolar_distance(mkpts0, mkpts1, E, K0, K1)


def estimate_pose(kpts0, kpts1, K0, K1, thresh: float, conf: float = 0.99999,
                  max_iters: int = 10000):
    """The reference pose protocol for one pair of pixel matches [N, 2]:
    essential-matrix RANSAC at ``thresh`` pixels (over the mean focal
    length) and confidence ``conf``, then ``recoverPose`` of each E it
    returns (points in front of both cameras and nearer than 50), each
    call starting from the previous call's cheirality mask (OpenCV writes
    it into the mask it is given).  Returns (R, t [3],
    inlier mask [N]) of the E with the most points in front, the mask as
    that E's call left it, or None.  ``max_iters`` does not reach the
    solver, as in the JAX package: RANSAC stops at OpenCV's 1000."""
    if len(kpts0) < 5:
        return None
    kpts0 = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    kpts1 = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    ransac_thr = thresh / np.mean([K0[0, 0], K1[1, 1], K0[0, 0], K1[1, 1]])
    E, mask = find_essential(kpts0, kpts1, ransac_thr, conf)
    if E is None:
        return None
    best_n, ret = 0, None
    for _E in E:
        # the JAX call's positional 1e9 lands in the R output of OpenCV's
        # overload without a distance: points count up to depth 50
        n, R, t, mask = recover_pose(_E, kpts0, kpts1, mask)
        if n > best_n:
            ret = (R, t, mask)
            best_n = n
    return ret


def compute_pose_errors(mkpts0, mkpts1, T_0to1, K0, K1,
                        pixel_thr: float = 0.5, conf: float = 0.99999):
    """Rotation and translation errors in degrees of one pair posed by
    ``estimate_pose``, and its inliers: (R_err, t_err, inliers), or (inf,
    inf, empty) where no pose was found."""
    ret = estimate_pose(mkpts0, mkpts1, K0, K1, pixel_thr, conf)
    if ret is None:
        return np.inf, np.inf, np.zeros((0,), bool)
    R, t, inliers = ret
    t_err, R_err = relative_pose_error(T_0to1, R, t)
    return R_err, t_err, inliers


def relative_pose_error(T_0to1, R, t, ignore_gt_t_thr: float = 0.0):
    """Angular errors in degrees of a pose (R, t) against T_0to1: of t up to
    its sign (the essential matrix's ambiguity) and of R.  Returns
    (t_err, R_err)."""
    t_gt = T_0to1[:3, 3]
    n = np.linalg.norm(t) * np.linalg.norm(t_gt)
    t_err = np.rad2deg(np.arccos(np.clip(np.dot(t, t_gt) / (n + 1e-12),
                                         -1.0, 1.0)))
    t_err = np.minimum(t_err, 180 - t_err)
    if np.linalg.norm(t_gt) < ignore_gt_t_thr:
        t_err = 0.0
    R_gt = T_0to1[:3, :3]
    cos = np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1.0, 1.0)
    return t_err, np.rad2deg(np.abs(np.arccos(cos)))


def error_auc(errors: Sequence[float], thresholds=(5, 10, 20)) -> Dict:
    """Area under the recall-against-error curve up to each threshold,
    normalized by it."""
    errors = [0] + sorted(float(e) for e in errors)
    recall = list(np.linspace(0, 1, len(errors)))
    aucs = {}
    for thr in thresholds:
        last = np.searchsorted(errors, thr)
        y = recall[:last] + [recall[last - 1]]
        x = errors[:last] + [thr]
        aucs[f"auc@{thr}"] = np.trapezoid(y, x) / thr
    return aucs


def epidist_prec(errors: Sequence[np.ndarray], thresholds) -> Dict:
    """Mean over pairs of the share of matches under each epipolar
    threshold (0 for a pair without matches)."""
    out = {}
    for thr in thresholds:
        prec = [np.mean(e < thr) if len(e) > 0 else 0 for e in errors]
        out[f"prec@{thr:.0e}"] = float(np.mean(prec)) if prec else 0.0
    return out


def gather_metrics(metrics: Dict) -> Dict:
    """The per-pair metric lists of every process (``parallel.comm.
    all_gather``), concatenated; in one process the identity.  Duplicate
    pairs are dropped later, in ``aggregate_metrics``."""
    from casmtr_tpu_torch.parallel import comm
    gathered = comm.all_gather(metrics)
    if len(gathered) == 1:
        return metrics
    return {k: [x for g in gathered for x in g[k]] for k in metrics}


def aggregate_metrics(metrics: Dict, epi_err_thr: float = 5e-4) -> Dict:
    """Dataset-level AUC of max(R_err, t_err) and epipolar precision.
    ``metrics`` holds lists: identifiers, R_errs, t_errs and epi_errs (one
    array per pair); of pairs with one identifier the last one counts."""
    unq = OrderedDict((iden, i)
                      for i, iden in enumerate(metrics["identifiers"]))
    ids = list(unq.values())
    pose_errors = np.max(np.stack([metrics["R_errs"], metrics["t_errs"]]),
                         axis=0)[ids]
    aucs = error_auc(pose_errors)
    precs = epidist_prec([metrics["epi_errs"][i] for i in ids],
                         [epi_err_thr])
    return {**aucs, **precs}
