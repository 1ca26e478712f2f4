"""Pose-graph optimisation: rotation averaging, then translation and scale
averaging (counterpart of casmtr_tpu/sfm/pose_graph.py).

The chain (``pipeline.chain_with_scale``) uses consecutive keyframe pairs
only, so drift grows along the sequence; the non-consecutive pairs the
pipeline also matches carry redundant relative poses that cancel it
before bundle adjustment.  Monocular relative translations have an
unknown scale per edge, so the classic two-stage decomposition applies,
each stage a small dense solve:

  1. **Rotation averaging**: damped Gauss-Newton on SO(3)^C, residual per
     edge ``log(R_j (R_ij R_i)^T)`` under left perturbations
     ``R_i <- exp(th_i) R_i``, Huber-IRLS weighted, camera 0 pinned.
  2. **Translation and scale averaging**: with rotations frozen the
     constraint ``t_j = R_ij t_i + s_e t_ij`` is linear in the camera
     translations and the per-edge scales, so each Huber-IRLS round is one
     exact weighted least-squares solve.  Gauge: t_0 pinned and the sum of
     the edge scales held to the initialisation's.

The JAX module's ``lax.scan`` loops are Python loops here; the accept
tests are selects on the device, so no loop waits on the host.  float32
on the device of the inputs.  Conventions as ``ba``: world->cam poses,
x_cam = R x_world + t.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from casmtr_tpu_torch.sfm.geometry import rodrigues


class PoseGraph(NamedTuple):
    """Edge set of relative-pose measurements.

    ei/ej: [E] int64 camera indices (the measurement maps cam ei -> cam
    ej); R_rel: [E, 3, 3]; t_rel: [E, 3] unit-norm translation directions;
    weight: [E] per-edge confidence (e.g. sqrt inlier count), 0 disables.
    """
    ei: torch.Tensor
    ej: torch.Tensor
    R_rel: torch.Tensor
    t_rel: torch.Tensor
    weight: torch.Tensor


def _log_so3(R: torch.Tensor) -> torch.Tensor:
    """Principal log map [.., 3, 3] -> [.., 3], differentiable and stable
    near 0 (the sinc form), with the theta ~ pi branch: there the skew part
    vanishes and the sinc form would score an exactly twisted rotation as a
    near-zero residual, so the axis comes from diag((R + I)/2) = a a^T and
    the residual has norm theta (its sign from the skew part)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    # theta / (2 sin theta), Taylor below the switch point
    f = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                    theta / (2.0 * torch.sin(theta)))
    d = torch.clamp(torch.diagonal(R, dim1=-2, dim2=-1) + 1.0, min=1e-12) / 2.0
    axis = torch.sqrt(d) * torch.where(v < 0.0, -1.0, 1.0)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1,
                                                       keepdim=True), min=1e-9)
    return torch.where((cos < -1.0 + 1e-4)[..., None],
                       theta[..., None] * axis, f[..., None] * v)


def _huber_w(norms: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights on the residual-vector norm, as ba._huber_weights."""
    return torch.where(norms <= delta, 1.0,
                       delta / torch.clamp(norms, min=1e-12))


def _pin(H: torch.Tensor, g: torch.Tensor, idx):
    """Gauge fix: the pinned variables' rows and columns zeroed, identity
    on their diagonal (the mask of ba.lm_step)."""
    mask = torch.ones(H.shape[0], dtype=H.dtype, device=H.device)
    mask[idx] = 0.0
    H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    return H, g * mask


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values of an even count."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


def average_rotations(Rs: torch.Tensor, g: PoseGraph, iters: int = 8,
                      huber_delta: float = 0.1,
                      damping: float = 1e-6) -> torch.Tensor:
    """Huber-IRLS Gauss-Newton rotation averaging.  Rs: [C, 3, 3] initial
    world->cam rotations; returns refined [C, 3, 3] with camera 0 pinned."""
    C = Rs.shape[0]
    dt, dev = Rs.dtype, Rs.device
    eye = torch.eye(3 * C, dtype=dt, device=dev)

    def residuals(theta, Rs):
        """theta: [C, 3] left perturbations; per-edge log residuals [E, 3]."""
        P = rodrigues(theta)                                   # [C, 3, 3]
        Ri = P[g.ei] @ Rs[g.ei]
        Rj = P[g.ej] @ Rs[g.ej]
        pred = g.R_rel @ Ri
        return _log_so3(Rj @ pred.transpose(-1, -2))

    z = torch.zeros((C, 3), dtype=dt, device=dev)
    for it in range(iters):
        r0 = residuals(z, Rs)                                  # [E, 3]
        rn = torch.linalg.vector_norm(r0, dim=-1)
        w = _huber_w(rn, huber_delta) * g.weight
        # trimmed IRLS: in the second half of the schedule gross outlier
        # edges are dropped (Huber alone leaves an O(delta) pull each)
        if it >= iters // 2:
            w = torch.where(rn > 3.0 * huber_delta, 0.0, w)
        sw = torch.sqrt(torch.clamp(w, min=0.0))[:, None]
        J = jacfwd(residuals)(z, Rs)                           # [E, 3, C, 3]
        Jf = (J * sw[..., None, None]).reshape(-1, 3 * C)
        rf = (r0 * sw).reshape(-1)
        H = Jf.T @ Jf + damping * eye
        gvec = -Jf.T @ rf
        H, gvec = _pin(H, gvec, slice(0, 3))                   # camera 0
        delta = torch.linalg.solve(H, gvec).reshape(C, 3)
        Rs2 = rodrigues(delta) @ Rs
        # accept only improving steps under the current robust weights
        better = (((residuals(z, Rs2) * sw) ** 2).sum()
                  <= ((r0 * sw) ** 2).sum())
        Rs = torch.where(better, Rs2, Rs)
    # re-orthonormalise: the nearest rotation of each (SVD, det fixed)
    u, _, vt = torch.linalg.svd(Rs)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    u = u * torch.stack([one, one, det], -1)[:, None, :]
    return u @ vt


def average_translations(Rs: torch.Tensor, ts: torch.Tensor, g: PoseGraph,
                         rounds: int = 4,
                         huber_delta: Optional[float] = None,
                         damping: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translation and per-edge-scale averaging with rotations frozen.

    Returns (ts [C, 3], s [E]).  Linear, solved exactly per IRLS round.
    Gauge: t_0 pinned; the sum of the edge scales held to the init's by a
    moderate prior row (a strong one collapses the float32 E x E block),
    then restored exactly by rescaling.  ``damping`` is an anchor-to-init
    Tikhonov term relative to the data block's mean diagonal, so that
    (near-)null directions stay at the init; it cannot rescue
    near-collinear trajectories (the caller gates on direction diversity,
    pipeline.refine_with_pose_graph)."""
    C, E = ts.shape[0], g.ei.shape[0]
    dt, dev = ts.dtype, ts.device
    Rrel = g.R_rel
    n = 3 * C + E

    def rotate(t):                                             # R_rel t_i
        return (Rrel @ t[g.ei][..., None])[..., 0]

    # init scales: the current pose difference projected on the edge dir
    s0 = (g.t_rel * (ts[g.ej] - rotate(ts))).sum(-1)
    s0 = torch.clamp(s0, min=1e-6)
    scale_unit = torch.clamp(_median(s0.abs()), min=1e-6)
    delta = scale_unit * 0.25 if huber_delta is None else huber_delta

    def edge_res(ts, s):
        return ts[g.ej] - rotate(ts) - s[:, None] * g.t_rel    # [E, 3]

    # the Jacobian in x = [dt (3C), ds (E)], analytic: d r_e / d t_j = I3,
    # / d t_i = -R_rel, / d s_e = -t_rel
    eyeC = torch.eye(C, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Jt = (eyeC[g.ej][:, None, :, None] * eye3[None, :, None, :]
          - eyeC[g.ei][:, None, :, None] * Rrel[:, :, None, :])
    Jt = Jt.reshape(E, 3, 3 * C)
    Js = -g.t_rel[..., None] * torch.eye(E, dtype=dt, device=dev)[:, None, :]
    J = torch.cat([Jt, Js], dim=-1)                            # [E, 3, n]
    # the scale-gauge prior row: sum(s) ~ sum(s0)
    prior_w = torch.sqrt(torch.clamp(g.weight.sum(), min=1.0))
    prow = torch.cat([torch.zeros(3 * C, dtype=dt, device=dev),
                      torch.ones(E, dtype=dt, device=dev)]) * prior_w
    eye_n = torch.eye(n, dtype=dt, device=dev)

    ts_init = ts
    s = s0
    for it in range(rounds):
        r0 = edge_res(ts, s)
        rn = torch.linalg.vector_norm(r0, dim=-1)
        w = _huber_w(rn, delta) * g.weight
        if it >= rounds // 2:                  # trimmed IRLS, later rounds
            w = torch.where(rn > 3.0 * delta, 0.0, w)
        sw = torch.sqrt(torch.clamp(w, min=0.0))
        Jf = (J * sw[:, None, None]).reshape(3 * E, n)
        rf = (r0 * sw[:, None]).reshape(3 * E)
        r_prior = prior_w * (s - s0).sum()
        H = Jf.T @ Jf + prow[:, None] * prow[None, :]
        # anchor-to-init Tikhonov, scaled by the data block's mean diagonal
        lam_a = (damping + 1e-7) * ((Jf ** 2).sum() / n)
        H = H + lam_a * eye_n
        anchor = torch.cat([(ts_init - ts).reshape(-1), s0 - s])
        gvec = -Jf.T @ rf - prow * r_prior + lam_a * anchor
        H, gvec = _pin(H, gvec, slice(0, 3))                   # t_0
        x = torch.linalg.solve(H, gvec)
        ts2 = ts + x[:3 * C].reshape(C, 3)
        s2 = s + x[3 * C:]
        # exact gauge restore by rescaling (residuals are 1-homogeneous in
        # (ts, s) when t_0 = 0), kept only for a sane round
        lam = s0.sum() / torch.clamp(s2.sum(), min=1e-12)
        sane = s2.sum() > 0.05 * s0.sum()
        lam = torch.where(sane & (torch.linalg.vector_norm(ts[0]) < 1e-9),
                          lam, torch.ones_like(lam))
        ts, s = ts2 * lam, s2 * lam
    return ts, s


def optimize_pose_graph(Rs: torch.Tensor, ts: torch.Tensor, g: PoseGraph,
                        rot_iters: int = 8, trans_rounds: int = 4,
                        huber_rot: float = 0.1,
                        huber_trans: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation averaging, then translation/scale averaging.  Rs [C, 3, 3]
    / ts [C, 3]: initial world->cam poses; returns refined (Rs, ts) with
    camera 0 and the chain's global scale kept (the monocular gauge)."""
    Rs = average_rotations(Rs, g, iters=rot_iters, huber_delta=huber_rot)
    ts, _ = average_translations(Rs, ts, g, rounds=trans_rounds,
                                 huber_delta=huber_trans)
    return Rs, ts
