"""Evaluation metrics (counterpart of casmtr_tpu/utils/metrics.py, in numpy):
the symmetric epipolar distance of matches, the relative pose error, and
the pose AUC and epipolar precision a dataset is scored by.

The JAX package poses each pair by OpenCV's RANSAC by default; the port
uses no OpenCV, so its evaluation poses every pair of a batch with the
batched device solver (``casmtr_tpu_torch.sfm.pose.estimate_pose_batch``,
the JAX package's ``--pose-solver device``), and ``estimate_pose`` /
``compute_pose_errors`` raise and name it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np

NO_CV2 = ("OpenCV's RANSAC (the JAX package's default pose protocol) is not "
          "ported: the port does not use OpenCV. Pose the pairs with the "
          "batched device solver, casmtr_tpu_torch.sfm.pose."
          "estimate_pose_batch (cli.evaluate.run_eval does)")


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


def estimate_pose(*args, **kwargs):
    """Not ported (OpenCV); see the module docstring."""
    raise NotImplementedError(NO_CV2)


def compute_pose_errors(*args, **kwargs):
    """Not ported (OpenCV); see the module docstring."""
    raise NotImplementedError(NO_CV2)


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
