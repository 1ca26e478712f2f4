"""Batched relative-pose estimation on the device: essential-matrix RANSAC
for every pair of a batch at once (counterpart of casmtr_tpu/sfm/pose.py,
the JAX package's ``evaluate --pose-solver device``).

Fixed shapes throughout: a match buffer of capacity M with a validity mask
per pair; S hypotheses drawn at once as random 8-subsets of the valid
matches (the Gumbel top-k trick: the 8 largest log-uniforms); each
hypothesis a weighted, Hartley-normalized 8-point nullspace projected onto
the essential manifold; Sampson-distance inliers in normalized camera
coordinates at the reference's threshold (pixel threshold over the mean
focal length); the best hypothesis re-fit twice on its inliers; the (R, t)
of its four decompositions with the most points in front of both cameras;
then five damped Gauss-Newton steps on the 5-dof pose (so(3) and the unit
sphere's tangent plane) against the signed Sampson residual of the inliers,
a step that raises the cost rejected.

The random draws come from a ``torch.Generator`` (seeded 0 on the
matches' device unless one is given) or are passed in as ``noise``, so that
a caller can feed another implementation's draw.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from casmtr_tpu_torch.ops.quadtree import topk_lowest_first

NOISE_MIN = 1e-6


class PoseResult(NamedTuple):
    R: torch.Tensor          # [B, 3, 3] rotation 0->1
    t: torch.Tensor          # [B, 3] unit translation 0->1
    inliers: torch.Tensor    # [B, M] bool
    n_inliers: torch.Tensor  # [B]
    ok: torch.Tensor         # [B] bool: enough inliers to trust the pose


def _mT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _normalize(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels [..., M, 2] -> normalized camera coordinates K^-1 [u, v, 1]."""
    pts = torch.cat([kpts, torch.ones_like(kpts[..., :1])], dim=-1)
    return pts @ _mT(torch.linalg.inv(K))


def _hartley(x: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor):
    """Weighted isotropic normalization of [..., N, 3] points (centred, RMS
    distance sqrt(2)): (normalized points, the 3x3 transform)."""
    mu = (x[..., :2] * w[..., None]).sum(-2) / wsum[..., None]    # [..., 2]
    xc = x[..., :2] - mu[..., None, :]
    rms = torch.sqrt(torch.clamp(((xc * xc).sum(-1) * w).sum(-1) / wsum,
                                 min=1e-12))
    s = math.sqrt(2.0) / rms                                      # [...]
    xn = torch.cat([xc * s[..., None, None], torch.ones_like(x[..., :1])], -1)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, zero, -s * mu[..., 0]], -1),
                     torch.stack([zero, s, -s * mu[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return xn, T


def _eight_point(x0: torch.Tensor, x1: torch.Tensor, w: torch.Tensor
                 ) -> torch.Tensor:
    """Weighted 8-point E (x1^T E x0 = 0) of [..., N, 3] point rows with row
    weights [..., N], projected onto the essential manifold.  The nullspace
    is the right singular vector of the smallest singular value: with fewer
    than 9 rows only the full V holds it; with more, the thin SVD does (the
    full one would build an N x N U)."""
    wsum = torch.clamp(w.sum(-1), min=1e-6)
    x0n, T0 = _hartley(x0, w, wsum)
    x1n, T1 = _hartley(x1, w, wsum)
    A = (x1n[..., :, None] * x0n[..., None, :]).flatten(-2) * w[..., None]
    vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)[2]
    F = _mT(T1) @ vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3) @ T0
    u, _, vt2 = torch.linalg.svd(F)
    keep = torch.tensor([1.0, 1.0, 0.0], device=F.device)
    return (u * keep) @ vt2


def _sampson(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
             ) -> torch.Tensor:
    """Squared Sampson distance [..., M] of rows x0/x1 [..., M, 3] under
    E [..., 3, 3]."""
    Ex0 = x0 @ _mT(E)
    Etx1 = x1 @ E
    num = (x1 * Ex0).sum(-1) ** 2
    den = torch.clamp(Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2
                      + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2, min=1e-12)
    return num / den


def _triangulate_depths(R, t, x0, x1):
    """Linear two-view depths (z0, z1) [..., M] of rows x0/x1 under (R, t):
    z0 x1 x (R x0) = -x1 x t."""
    Rx0 = x0 @ _mT(R)
    c = torch.linalg.cross(*torch.broadcast_tensors(x1, Rx0))
    d = torch.linalg.cross(*torch.broadcast_tensors(x1, t[..., None, :]))
    z0 = -(c * d).sum(-1) / torch.clamp((c * c).sum(-1), min=1e-12)
    z1 = (z0[..., None] * Rx0 + t[..., None, :])[..., 2]
    return z0, z1


def _decompose(E: torch.Tensor):
    """The four (R, t) of [..., 3, 3] essential matrices: [..., 4, 3, 3],
    [..., 4, 3] (sign(det) is 0 at 0, as jnp.sign)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' exponential of [..., 3], first order below 1e-8."""
    theta = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    K = _skew(w / torch.clamp(theta[..., 0], min=1e-12))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta < 1e-8, eye + _skew(w), R)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 2] orthonormal basis of the plane orthogonal to unit t,
    built on the axis least aligned with t (the first on ties)."""
    a = torch.eye(3, dtype=t.dtype, device=t.device)[t.abs().argmin(-1)]
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1,
                                                   keepdim=True), min=1e-12)
    return torch.stack([b1, torch.linalg.cross(t, b1)], dim=-1)


def _residuals(params, R, t, basis, x0, x1, w):
    """Signed, weighted Sampson residuals [M] of one pair at the pose (R, t)
    moved by params [5] (3 of rotation, 2 along ``basis``)."""
    Rp = _exp_so3(params[:3]) @ R
    tp = t + basis @ params[3:]
    tp = tp / torch.clamp(torch.linalg.vector_norm(tp), min=1e-12)
    E = _skew(tp) @ Rp
    Ex0 = x0 @ E.T
    Etx1 = x1 @ E
    num = (x1 * Ex0).sum(-1)
    den = torch.clamp(Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2
                      + Etx1[:, 1] ** 2, min=1e-12)
    return num / torch.sqrt(den) * w


_batched_residuals = vmap(_residuals)
_batched_jacobian = vmap(jacfwd(_residuals))


def _polish_pose(R, t, x0, x1, w, iters: int = 5):
    """Damped Gauss-Newton on the batch's poses against the signed Sampson
    residual of the rows weighted by w [B, M]; a step that raises a pair's
    cost is rejected."""
    z = torch.zeros(R.shape[0], 5, dtype=R.dtype, device=R.device)
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        basis = _tangent_basis(t)
        r0 = _batched_residuals(z, R, t, basis, x0, x1, w)        # [B, M]
        J = _batched_jacobian(z, R, t, basis, x0, x1, w)          # [B, M, 5]
        H = _mT(J) @ J
        H = (H + 1e-8 * H.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None]
             * eye5 + 1e-20 * eye5)
        delta = -torch.linalg.solve(H, (_mT(J) @ r0[..., None])[..., 0])
        Rn = _exp_so3(delta[:, :3]) @ R
        tn = t + (basis @ delta[:, 3:, None])[..., 0]
        tn = tn / torch.clamp(torch.linalg.vector_norm(tn, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        cost = (_batched_residuals(z, Rn, tn, _tangent_basis(tn), x0, x1, w)
                ** 2).sum(-1)
        better = cost <= (r0 ** 2).sum(-1)
        R = torch.where(better[:, None, None], Rn, R)
        t = torch.where(better[:, None], tn, t)
    return R, t


def pose_noise(B: int, n_hyp: int, M: int, generator: torch.Generator,
               device) -> torch.Tensor:
    """The hypotheses' uniform draw [B, n_hyp, M] in [1e-6, 1)."""
    u = torch.rand((B, n_hyp, M), generator=generator, device=device)
    return NOISE_MIN + u * (1.0 - NOISE_MIN)


def estimate_pose_batch(kpts0, kpts1, valid, K0, K1, thr_px: float = 0.5,
                        n_hyp: int = 512, min_inliers: int = 12,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None) -> PoseResult:
    """Essential-matrix RANSAC and pose recovery for a batch of pairs.

    kpts0/kpts1: [B, M, 2] pixel matches (a fixed-capacity buffer); valid:
    [B, M] bool; K0/K1: [B, 3, 3].  ``thr_px`` is the reference's RANSAC
    pixel threshold (TRAINER.RANSAC_PIXEL_THR, 0.5).  The hypotheses'
    draw is ``noise`` [B, n_hyp, M] (uniform in [1e-6, 1)) if given, else
    from ``generator`` (a generator on the matches' device, seeded 0 if
    none is given).  Float32 throughout."""
    dev = kpts0.device
    kpts0, kpts1 = kpts0.float(), kpts1.float()
    K0, K1 = K0.float(), K1.float()
    valid = valid.bool()
    B, M = valid.shape
    x0 = _normalize(kpts0, K0)                                    # [B, M, 3]
    x1 = _normalize(kpts1, K1)
    f_mean = (K0[:, 0, 0] + K0[:, 1, 1] + K1[:, 0, 0] + K1[:, 1, 1]) / 4.0
    thr2 = (thr_px / f_mean) ** 2                                 # [B]

    # hypothesize: n_hyp random 8-subsets of the valid rows
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        noise = pose_noise(B, n_hyp, M, generator, dev)
    scores = torch.log(noise.to(dev, torch.float32)) + torch.where(
        valid[:, None, :], 0.0, -1e9)
    _, subset = topk_lowest_first(scores, 8, dim=2)               # [B, S, 8]
    bi = torch.arange(B, device=dev)[:, None, None]
    Es = _eight_point(x0[bi, subset], x1[bi, subset],
                      torch.ones(subset.shape, device=dev))        # [B, S, 3, 3]

    # verify: Sampson inliers per hypothesis
    d2 = _sampson(Es, x0[:, None], x1[:, None])                   # [B, S, M]
    counts = ((d2 < thr2[:, None, None]) & valid[:, None]).sum(-1)
    E = Es[torch.arange(B, device=dev), counts.argmax(dim=1)]

    # refine: two inlier-weighted 8-point fits on all rows, the previous
    # model kept where fewer than 8 rows are inliers
    for _ in range(2):
        w = ((_sampson(E, x0, x1) < thr2[:, None]) & valid).float()
        E = torch.where((w.sum(-1) >= 8)[:, None, None],
                        _eight_point(x0, x1, w), E)
    inliers = (_sampson(E, x0, x1) < thr2[:, None]) & valid

    # cheirality: the decomposition with the most positive depths
    Rs, ts = _decompose(E)
    z0, z1 = _triangulate_depths(Rs, ts, x0[:, None], x1[:, None])
    pos = ((z0 > 0) & (z1 > 0) & inliers[:, None]).sum(-1)        # [B, 4]
    pick = pos.argmax(dim=1)
    b = torch.arange(B, device=dev)
    R, t = Rs[b, pick], ts[b, pick]
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                        min=1e-12)

    # polish on the inliers, then the final inlier set
    R, t = _polish_pose(R, t, x0, x1, inliers.float())
    inliers = (_sampson(_skew(t) @ R, x0, x1) < thr2[:, None]) & valid
    n_inl = inliers.sum(-1)
    return PoseResult(R, t, inliers, n_inl, n_inl >= min_inliers)
