"""Perspective-n-point on the host: EPnP inside RANSAC (the port's
counterpart of OpenCV's ``solvePnPRansac(..., flags=SOLVEPNP_EPNP)`` and
``Rodrigues``, which the JAX package's SfM pipeline calls; the port does
not use OpenCV).

float64 numpy throughout, as OpenCV's.  ``epnp`` follows Lepetit, Moreno-
Noguer and Fua, "EPnP: an accurate O(n) solution to the PnP problem"
(IJCV 2009): four control points (the centroid and the principal axes of
the world points), barycentric coordinates, the 2n x 12 system M, the
null space of M^T M (its four eigenvectors of the smallest eigenvalues),
the three beta approximations (N = 1, 2, 3) each refined by five
Gauss-Newton steps, and the one with the least mean reprojection error;
pose from the camera-frame points by SVD.  ``solve_pnp_ransac`` samples
minimal sets of 5 points, keeps the model with the most inliers (squared
reprojection error at most ``reprojection_error``^2), shrinks the number
of iterations with the inlier ratio as OpenCV's ``RANSACUpdateNumIters``
does, then fits EPnP to the best model's inliers.  Its draws come from a
seeded ``np.random.Generator``: it cannot repeat OpenCV's, so the
contract is the pose and the inlier set wherever the data determine them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# the (a, b) control-point pairs of the six distance constraints
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def rodrigues(rvec) -> np.ndarray:
    """Axis-angle [3] -> rotation matrix [3, 3] (float64)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    Kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return (np.eye(3) + math.sin(theta) * Kx
            + (1.0 - math.cos(theta)) * (Kx @ Kx))


def rotation_to_rvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix [3, 3] -> axis-angle [3] (float64), with the theta
    ~ pi branch (axis from the largest column of R + I)."""
    R = np.asarray(R, np.float64)
    cos = min(max((np.trace(R) - 1.0) / 2.0, -1.0), 1.0)
    theta = math.acos(cos)
    skew = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-12:
        return skew / 2.0
    if theta > math.pi - 1e-3:
        B = R + np.eye(3)
        col = B[:, int(np.argmax(np.diag(B)))]
        axis = col / max(np.linalg.norm(col), 1e-12)
        if axis @ skew < 0:
            axis = -axis
        return axis * theta
    return skew / (2.0 * math.sin(theta)) * theta


def _betas_1(L, rho):
    b4 = np.linalg.lstsq(L[:, [0, 1, 3, 6]], rho, rcond=None)[0]
    b0 = math.sqrt(abs(b4[0]))
    sign = -1.0 if b4[0] < 0 else 1.0
    return np.array([b0, sign * b4[1] / b0, sign * b4[2] / b0,
                     sign * b4[3] / b0])


def _betas_2(L, rho):
    b3 = np.linalg.lstsq(L[:, [0, 1, 2]], rho, rcond=None)[0]
    if b3[0] < 0:
        b0 = math.sqrt(-b3[0])
        b1 = math.sqrt(-b3[2]) if b3[2] < 0 else 0.0
    else:
        b0 = math.sqrt(b3[0])
        b1 = math.sqrt(b3[2]) if b3[2] > 0 else 0.0
    if b3[1] < 0:
        b0 = -b0
    return np.array([b0, b1, 0.0, 0.0])


def _betas_3(L, rho):
    b5 = np.linalg.lstsq(L[:, :5], rho, rcond=None)[0]
    if b5[0] < 0:
        b0 = math.sqrt(-b5[0])
        b1 = math.sqrt(-b5[2]) if b5[2] < 0 else 0.0
    else:
        b0 = math.sqrt(b5[0])
        b1 = math.sqrt(b5[2]) if b5[2] > 0 else 0.0
    if b5[1] < 0:
        b0 = -b0
    return np.array([b0, b1, b5[3] / b0 if b0 != 0 else 0.0, 0.0])


def _gauss_newton(L, rho, betas, iters: int = 5):
    """Five Gauss-Newton steps on the six distance constraints."""
    betas = betas.copy()
    for _ in range(iters):
        b = betas
        quad = np.array([b[0] * b[0], b[0] * b[1], b[1] * b[1], b[0] * b[2],
                         b[1] * b[2], b[2] * b[2], b[0] * b[3], b[1] * b[3],
                         b[2] * b[3], b[3] * b[3]])
        A = np.stack([
            2 * L[:, 0] * b[0] + L[:, 1] * b[1] + L[:, 3] * b[2]
            + L[:, 6] * b[3],
            L[:, 1] * b[0] + 2 * L[:, 2] * b[1] + L[:, 4] * b[2]
            + L[:, 7] * b[3],
            L[:, 3] * b[0] + L[:, 4] * b[1] + 2 * L[:, 5] * b[2]
            + L[:, 8] * b[3],
            L[:, 6] * b[0] + L[:, 7] * b[1] + L[:, 8] * b[2]
            + 2 * L[:, 9] * b[3]], axis=1)
        betas = betas + np.linalg.lstsq(A, rho - L @ quad, rcond=None)[0]
    return betas


def epnp(pts3: np.ndarray, pts2: np.ndarray, K: np.ndarray):
    """EPnP pose of world points pts3 [n, 3] seen at pixels pts2 [n, 2]
    (n >= 4) through K: (R [3, 3], t [3], mean reprojection error px)."""
    pw = np.asarray(pts3, np.float64)
    us = np.asarray(pts2, np.float64)
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    n = len(pw)
    # control points: the centroid, then the principal axes
    c0 = pw.mean(0)
    pw0 = pw - c0
    _, dc, uct = np.linalg.svd(pw0.T @ pw0)
    cws = np.concatenate(
        [c0[None], c0 + np.sqrt(dc / n)[:, None] * uct], axis=0)  # [4, 3]
    # barycentric coordinates
    CC = (cws[1:] - c0).T                                         # [3, 3]
    a = pw0 @ np.linalg.pinv(CC).T                                # [n, 3]
    alphas = np.concatenate([1.0 - a.sum(1, keepdims=True), a], axis=1)
    # M: two rows per point, 12 unknowns (the control points in camera)
    M = np.zeros((2 * n, 12))
    M[0::2, 0::3] = alphas * fu
    M[0::2, 2::3] = alphas * (uc - us[:, :1])
    M[1::2, 1::3] = alphas * fv
    M[1::2, 2::3] = alphas * (vc - us[:, 1:])
    evals, evecs = np.linalg.eigh(M.T @ M)          # ascending eigenvalues
    v = evecs[:, :4].T.reshape(4, 4, 3)             # v[i]: i-th smallest
    dv = np.stack([v[:, a_] - v[:, b_] for a_, b_ in _PAIRS], axis=1)
    dot = np.einsum("ijk,ljk->jil", dv, dv)          # [6, 4, 4]
    L = np.stack([dot[:, 0, 0], 2 * dot[:, 0, 1], dot[:, 1, 1],
                  2 * dot[:, 0, 2], 2 * dot[:, 1, 2], dot[:, 2, 2],
                  2 * dot[:, 0, 3], 2 * dot[:, 1, 3], 2 * dot[:, 2, 3],
                  dot[:, 3, 3]], axis=1)                          # [6, 10]
    rho = np.array([np.sum((cws[a_] - cws[b_]) ** 2) for a_, b_ in _PAIRS])

    def pose(betas):
        ccs = np.einsum("i,ijk->jk", betas, v)                    # [4, 3]
        pcs = alphas @ ccs                                        # [n, 3]
        if pcs[0, 2] < 0:
            pcs = -pcs
        pc0 = pcs.mean(0)
        U, _, Vt = np.linalg.svd((pcs - pc0).T @ pw0)
        R = U @ Vt
        if np.linalg.det(R) < 0:
            R[2] = -R[2]
        t = pc0 - R @ c0
        Xc = pw @ R.T + t
        proj = np.stack([uc + fu * Xc[:, 0] / Xc[:, 2],
                         vc + fv * Xc[:, 1] / Xc[:, 2]], axis=1)
        return R, t, float(np.mean(np.linalg.norm(us - proj, axis=1)))

    best = None
    for approx in (_betas_1, _betas_2, _betas_3):
        cand = pose(_gauss_newton(L, rho, approx(L, rho)))
        if best is None or cand[2] < best[2]:
            best = cand
    return best


def _update_iters(p: float, ep: float, model_points: int,
                  max_iters: int) -> int:
    """OpenCV's RANSACUpdateNumIters: the iterations that reach confidence
    ``p`` at outlier ratio ``ep``, never more than ``max_iters``."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(np.rint(num / denom))


def _sq_errors(R, t, pts3, pts2, K) -> np.ndarray:
    Xc = pts3 @ R.T + t
    uv = Xc @ K.T
    proj = uv[:, :2] / uv[:, 2:3]
    return ((proj - pts2) ** 2).sum(1)


def solve_pnp_ransac(pts3, pts2, K, reprojection_error: float = 8.0,
                     iterations: int = 100, confidence: float = 0.99,
                     seed: int = 0
                     ) -> Tuple[bool, np.ndarray, np.ndarray,
                                Optional[np.ndarray]]:
    """RANSAC over 5-point EPnP, then EPnP on the best model's inliers.

    pts3 [n, 3], pts2 [n, 2], K [3, 3].  Returns (ok, rvec [3, 1], tvec
    [3, 1], inliers [k, 1] int32 or None), OpenCV's shapes; the inliers are
    the best RANSAC model's, as OpenCV's.  Draws from
    ``np.random.default_rng(seed)``."""
    pts3 = np.asarray(pts3, np.float64).reshape(-1, 3)
    pts2 = np.asarray(pts2, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(pts3)
    model_points = 5
    rng = np.random.default_rng(seed)
    zero = np.zeros((3, 1))
    if n < model_points:
        return False, zero, zero, None
    thr2 = float(reprojection_error) ** 2
    if n == model_points:
        best_mask = np.ones(n, bool)
    else:
        best_mask, best_count = None, 0
        niters, it = max(int(iterations), 1), 0
        while it < niters:
            sample = rng.choice(n, model_points, replace=False)
            R, t, _ = epnp(pts3[sample], pts2[sample], K)
            it += 1
            if not (np.all(np.isfinite(R)) and np.all(np.isfinite(t))):
                continue
            mask = _sq_errors(R, t, pts3, pts2, K) <= thr2
            count = int(mask.sum())
            if count > max(best_count, model_points - 1):
                best_mask, best_count = mask, count
                niters = _update_iters(confidence, (n - count) / n,
                                       model_points, niters)
        if best_mask is None:
            return False, zero, zero, None
    R, t, _ = epnp(pts3[best_mask], pts2[best_mask], K)
    inliers = np.flatnonzero(best_mask).astype(np.int32)[:, None]
    return (True, rotation_to_rvec(R)[:, None], t[:, None], inliers)
