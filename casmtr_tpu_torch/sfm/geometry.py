"""Core SfM geometry in PyTorch: rotations, projection, triangulation
(counterpart of casmtr_tpu/sfm/geometry.py).

Every function is batched over leading dimensions, where the JAX callers
``vmap`` the single-item functions, and computes in the dtype and on the
device of its inputs.
"""

from __future__ import annotations

import math

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the unnormalised skew matrices [..., 3, 3]."""
    rx, ry, rz = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(rx)
    return torch.stack([
        torch.stack([zero, -rz, ry], -1),
        torch.stack([rz, zero, -rx], -1),
        torch.stack([-ry, rx, zero], -1),
    ], -2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [.., 3] -> rotation matrix [.., 3, 3].

    Written with the UNNORMALIZED skew matrix and sinc-style coefficients
    ``R = I + a(th) K + b(th) K^2`` (a = sin th / th, b = (1-cos th)/th^2),
    the small-angle branch selected on the input, so that the Jacobian
    (``torch.func.jacfwd``) is finite and exact at theta = 0: the first
    rotation of bundle adjustment and of pose averaging is the identity."""
    theta2 = (rvec * rvec).sum(-1, keepdim=True)                  # [.., 1]
    small = theta2 < 1e-12
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    K = _skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def project(rvec: torch.Tensor, tvec: torch.Tensor, X: torch.Tensor,
            K: torch.Tensor) -> torch.Tensor:
    """Project world points into cameras.  rvec/tvec: [.., 3]; X: [.., N, 3]
    (or [.., 3] for one point per camera); K: [.., 3, 3].  Returns pixel
    coordinates [.., N, 2] (or [.., 2])."""
    R = rodrigues(rvec)
    if X.dim() == rvec.dim():                  # one point per camera
        Xc = (R @ X[..., None])[..., 0] + tvec
        uv = (K @ Xc[..., None])[..., 0]
    else:
        Xc = X @ R.transpose(-1, -2) + tvec[..., None, :]
        uv = Xc @ K.transpose(-1, -2)
    return uv[..., :2] / torch.clamp(uv[..., 2:3], min=1e-9)


def triangulate(P0: torch.Tensor, P1: torch.Tensor, uv0: torch.Tensor,
                uv1: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) two-view triangulation.

    P0/P1: [.., 3, 4] projection matrices; uv0/uv1: [.., N, 2] pixels.
    Returns [.., N, 3] world points: the right singular vector of the
    smallest singular value of each 4x4 system, with a sign-preserving
    clamp of its last coordinate, so that degenerate pairs (no baseline,
    pure rotation) give finite points (the cheirality test rejects them
    later)."""
    P0 = P0[..., None, :, :]
    P1 = P1[..., None, :, :]
    A = torch.stack([
        uv0[..., 0:1] * P0[..., 2, :] - P0[..., 0, :],
        uv0[..., 1:2] * P0[..., 2, :] - P0[..., 1, :],
        uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
    ], -2)                                                       # [.., N, 4, 4]
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[..., 3:4]
    w = torch.where(w >= 0, torch.clamp(w, min=1e-12),
                    torch.clamp(w, max=-1e-12))
    return X[..., :3] / w


def rotation_to_rvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [.., 3, 3] -> axis-angle [.., 3] (principal branch),
    including the theta ~ pi branch where the skew-part axis vanishes:
    there R ~ 2 a a^T - I, and the axis is the column of R + I with the
    largest diagonal entry (its sign is arbitrary at exactly pi)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.clamp(torch.linalg.vector_norm(skew, dim=-1, keepdim=True),
                    min=1e-12)
    axis_generic = skew / s
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    k = torch.diagonal(B, dim1=-2, dim2=-1).argmax(-1)            # [..]
    col = torch.gather(B, -1, k[..., None, None].expand(
        *k.shape, 3, 1))[..., 0]
    axis_pi = col / torch.clamp(torch.linalg.vector_norm(
        col, dim=-1, keepdim=True), min=1e-12)
    axis = torch.where((theta > math.pi - 1e-3)[..., None], axis_pi,
                       axis_generic)
    return axis * theta[..., None]
