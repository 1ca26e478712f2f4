"""Bundle adjustment: Levenberg-Marquardt with Schur-complement landmark
marginalisation (counterpart of casmtr_tpu/sfm/ba.py), on one device.

Observations are fixed-size arrays with a validity mask; invalid
observations contribute zeros.  Everything runs on the device the
problem's tensors live on (``to_device``; ``reconstruct.build_problem``
places it), in float32, with TF32 off on the card.

Two solver formulations:

* ``solver="dense"`` materialises the camera-point cross block B as
  [P, C, 6, 3] and the reduced camera system S as [6C, 6C], and solves it
  directly: for small problems.
* ``solver="cg"`` is the track-structured sparse Schur complement: B's
  only nonzero 6x3 blocks are the per-observation W_n = Jc_n^T Jp_n, so S
  is never formed.  S @ x is applied matrix-free in two gather /
  segment-sum passes (O(N) memory and work), and the gauge-fixed system is
  solved by preconditioned conjugate gradients with a block-Jacobi
  (per-camera 6x6) preconditioner.

Segment sums are ``index_add_``; on the card it sums with atomics, in an
order that varies from run to run, so card and CPU results agree to
float32 rounding, not bit for bit.  The JAX module's landmark-sharded
variant (``axis_name``, a psum over a mesh) is not ported here (ROADMAP
queue A item 6).

The PCG loop reads one device scalar per iteration (its stop rule) on the
host; ``HOST_SYNCS["pcg"]`` counts those reads.  The LM loop itself never
waits: accept and reject are selects on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from casmtr_tpu_torch.serving import configure_card, resolve_device
from casmtr_tpu_torch.sfm.geometry import project

HOST_SYNCS: Dict[str, int] = {"pcg": 0}


class BAProblem(NamedTuple):
    """A batch of observations linking cameras and points.

    cam_rvec: [C, 3]; cam_tvec: [C, 3]; points: [P, 3]; K: [3, 3] (shared
    calibrated intrinsics); obs_cam/obs_pt: [N] int64; obs_uv: [N, 2];
    obs_valid: [N] bool.
    """
    cam_rvec: torch.Tensor
    cam_tvec: torch.Tensor
    points: torch.Tensor
    K: torch.Tensor
    obs_cam: torch.Tensor
    obs_pt: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor


def to_device(p: BAProblem, device=None) -> BAProblem:
    """``p`` on ``device`` (None: the card; without CUDA that raises)."""
    dev = resolve_device(device)
    return BAProblem(*(t.to(dev) for t in p))


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``n`` segments by ``idx`` (index_add_)."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, idx, x)


def reprojection_residuals(p: BAProblem) -> torch.Tensor:
    """[N, 2] masked residuals."""
    r = project(p.cam_rvec[p.obs_cam], p.cam_tvec[p.obs_cam],
                p.points[p.obs_pt], p.K) - p.obs_uv
    return torch.where(p.obs_valid[:, None], r, 0.0)


def _residual_fn(cam6, X, uv, K):
    return project(cam6[:3], cam6[3:], X, K) - uv


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber loss on the 2-vector residual norm:
    1 inside the delta tube, delta/||r|| outside. [N, 1]."""
    n = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    return torch.where(n <= delta, 1.0, delta / torch.clamp(n, min=1e-12))


def robust_cost(p: BAProblem, huber_delta: Optional[float]) -> torch.Tensor:
    """Sum of rho(||r_n||): squared inside delta, linear outside; the plain
    squared cost when huber_delta is None."""
    r = reprojection_residuals(p)
    if huber_delta is None:
        return (r ** 2).sum()
    n = torch.linalg.vector_norm(r, dim=-1)
    d = huber_delta
    rho = torch.where(n <= d, n ** 2, 2 * d * n - d * d)
    return torch.where(p.obs_valid, rho, 0.0).sum()


def _jacobians(p: BAProblem, huber_delta: Optional[float] = None):
    """Per-observation Jacobians J_c [N, 2, 6], J_p [N, 2, 3] and residuals
    [N, 2] (forward-mode, ``jacfwd`` under ``vmap``).  With
    ``huber_delta``, residuals and Jacobians carry the square root of the
    IRLS Huber weight, a constant within the step."""
    cams6 = torch.cat([p.cam_rvec, p.cam_tvec], dim=-1)
    K = p.K

    def one(c, X, uv):
        r = _residual_fn(c, X, uv, K)
        Jc, Jp = jacfwd(_residual_fn, argnums=(0, 1))(c, X, uv, K)
        return r, Jc, Jp

    r, Jc, Jp = vmap(one)(cams6[p.obs_cam], p.points[p.obs_pt], p.obs_uv)
    if huber_delta is not None:
        sw = torch.sqrt(_huber_weights(r, huber_delta))
        r = r * sw
        Jc = Jc * sw[..., None]
        Jp = Jp * sw[..., None]
    m = p.obs_valid[:, None]
    return (torch.where(m, r, 0.0), torch.where(m[..., None], Jc, 0.0),
            torch.where(m[..., None], Jp, 0.0))


def _normal_blocks(p: BAProblem, lam: torch.Tensor,
                   huber_delta: Optional[float]):
    """The blocks both solvers share: camera blocks Hcc [C, 6, 6] and g_c
    [C, 6], point gradients g_p [P, 3], the damped inverse point blocks
    Vinv [P, 3, 3] and the per-observation cross blocks W [N, 6, 3]."""
    C, P = p.cam_rvec.shape[0], p.points.shape[0]
    r, Jc, Jp = _jacobians(p, huber_delta)
    Hcc = _segment_sum(torch.einsum("nij,nik->njk", Jc, Jc), p.obs_cam, C)
    g_c = _segment_sum(-torch.einsum("nij,ni->nj", Jc, r), p.obs_cam, C)
    Hpp = _segment_sum(torch.einsum("nij,nik->njk", Jp, Jp), p.obs_pt, P)
    g_p = _segment_sum(-torch.einsum("nij,ni->nj", Jp, r), p.obs_pt, P)
    W = torch.einsum("nij,nik->njk", Jc, Jp)                   # [N, 6, 3]
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Vinv = torch.linalg.inv(Hpp + (lam + 1e-12) * eye3)
    return Hcc, g_c, g_p, W, Vinv


def _schur_system(p: BAProblem, lam: torch.Tensor,
                  huber_delta: Optional[float] = None):
    """The dense reduced camera system (S [6C, 6C], b [6C]) and the point
    back-substitution operands (B [P, C, 6, 3], Vinv, g_p)."""
    C, P = p.cam_rvec.shape[0], p.points.shape[0]
    Hcc, g_c, g_p, W, Vinv = _normal_blocks(p, lam, huber_delta)
    # cross blocks aggregated per (point, camera)
    B = _segment_sum(W, p.obs_pt * C + p.obs_cam, P * C).reshape(P, C, 6, 3)
    # S = Hcc_diag - sum_p B_p Vinv_p B_p^T ; b = g_c - B Vinv g_p
    eyeC = torch.eye(C, dtype=Hcc.dtype, device=Hcc.device)
    BV = torch.einsum("pcij,pjk->pcik", B, Vinv)
    S = (torch.einsum("cij,cd->cidj", Hcc, eyeC)
         - torch.einsum("pcik,pdlk->cidl", BV, B))
    b = g_c - torch.einsum("pcik,pk->ci", BV, g_p)
    S = S.reshape(6 * C, 6 * C)
    S = S + lam * torch.eye(6 * C, dtype=S.dtype, device=S.device)
    return S, b.reshape(6 * C), (B, Vinv, g_p)


def _schur_operators(p: BAProblem, lam: torch.Tensor,
                     huber_delta: Optional[float] = None):
    """The sparse Schur system: matrix-free S @ x, rhs b [C, 6],
    block-Jacobi preconditioner blocks D [C, 6, 6], and the landmark
    back-substitution operands (W, Vinv, g_p).  A (point, camera) pair
    observed k times contributes k summed W_n blocks, which the two-pass
    matvec handles exactly."""
    C, P = p.cam_rvec.shape[0], p.points.shape[0]
    Hcc, g_c, g_p, W, Vinv = _normal_blocks(p, lam, huber_delta)

    # rhs: b = g_c - B Vinv g_p, accumulated per observation
    Vg = torch.einsum("pjk,pk->pj", Vinv, g_p)                 # [P, 3]
    b = g_c - _segment_sum(torch.einsum("nij,nj->ni", W, Vg[p.obs_pt]),
                           p.obs_cam, C)

    def matvec(x):                                             # x: [C, 6]
        # (B^T x) gathered per observation, reduced per landmark
        t = _segment_sum(torch.einsum("nij,ni->nj", W, x[p.obs_cam]),
                         p.obs_pt, P)                          # [P, 3]
        y = torch.einsum("pjk,pk->pj", Vinv, t)
        z = _segment_sum(torch.einsum("nij,nj->ni", W, y[p.obs_pt]),
                         p.obs_cam, C)                         # [C, 6]
        return torch.einsum("cij,cj->ci", Hcc, x) + lam * x - z

    # block-Jacobi preconditioner: the per-camera diagonal 6x6 of S (the
    # same-observation term of the Schur product; duplicate (p, c) cross
    # terms are dropped -- a preconditioner need not be exact)
    WVW = _segment_sum(torch.einsum("nij,njk,nlk->nil", W, Vinv[p.obs_pt], W),
                       p.obs_cam, C)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    D = Hcc + lam * eye6 - WVW
    return matvec, b, D, (W, Vinv, g_p)


def _pcg(matvec, b, Dinv, iters: int, tol: float):
    """Preconditioned conjugate gradients on the gauge-fixed reduced camera
    system; iterates are camera-sized [C, 6].  The loop runs while
    ``(i < iters) & (rz > stop)``: one host read of rz per iteration.

    Float32 note (as the JAX module's): S @ x is Hcc @ x - B Vinv B^T x,
    two large cancelling terms, so the matvec carries ~1e-3 relative
    rounding and CG stalls there rather than at tol; LM absorbs the
    inexact steps."""
    def prec(r):
        return torch.einsum("cij,cj->ci", Dinv, r)

    def dot(a, c):
        return (a * c).sum()

    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    pv = z
    rz = dot(r, z)
    stop = torch.clamp(tol * tol * dot(b, prec(b)), min=1e-30)
    i = 0
    while i < iters:
        HOST_SYNCS["pcg"] += 1
        if not bool(rz > stop):                    # the host waits here
            break
        Ap = matvec(pv)
        alpha = rz / torch.clamp(dot(pv, Ap), min=1e-30)
        x = x + alpha * pv
        r = r - alpha * Ap
        z = prec(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        pv = z + beta * pv
        rz = rz_new
        i += 1
    return x


def lm_step(p: BAProblem, lam: torch.Tensor,
            fix_first_cam: bool = True,
            huber_delta: Optional[float] = None,
            solver: str = "dense",
            cg_iters: int = 100,
            cg_tol: float = 1e-6
            ) -> Tuple[BAProblem, torch.Tensor]:
    """One damped Gauss-Newton (LM) step.  Returns (updated problem, new
    cost).  ``fix_first_cam`` pins the gauge: camera 0's update is zero."""
    C = p.cam_rvec.shape[0]
    dt, dev = p.points.dtype, p.points.device
    if solver == "cg":
        matvec, b, D, (W, Vinv, g_p) = _schur_operators(p, lam, huber_delta)
        m = torch.ones((C, 6), dtype=dt, device=dev)
        if fix_first_cam:
            m[0] = 0.0
            D = D.clone()
            D[0] = torch.eye(6, dtype=dt, device=dev)

        def op(x):
            # gauge-projected operator: the identity on the pinned block
            return m * matvec(m * x) + (1.0 - m) * x

        dc = m * _pcg(op, m * b, torch.linalg.inv(D), cg_iters, cg_tol)
        # back-substitute landmarks: dp = Vinv (g_p - B^T dc)
        t = _segment_sum(torch.einsum("nij,ni->nj", W, dc[p.obs_cam]),
                         p.obs_pt, p.points.shape[0])
        dp = torch.einsum("pjk,pk->pj", Vinv, g_p - t)
    elif solver == "dense":
        S, b, (B, Vinv, g_p) = _schur_system(p, lam, huber_delta)
        if fix_first_cam:
            # pin the first camera: its rows and columns zeroed, identity
            mask = torch.ones(6 * C, dtype=dt, device=dev)
            mask[:6] = 0.0
            S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
            b = b * mask
        dc = torch.linalg.solve(S, b).reshape(C, 6)
        rhs = g_p - torch.einsum("pcij,ci->pj", B, dc)
        dp = torch.einsum("pjk,pk->pj", Vinv, rhs)
    else:
        raise ValueError(f"unknown BA solver {solver!r}")

    new = p._replace(cam_rvec=p.cam_rvec + dc[:, :3],
                     cam_tvec=p.cam_tvec + dc[:, 3:],
                     points=p.points + dp)
    return new, robust_cost(new, huber_delta)


def run_ba(p: BAProblem, iters: int = 20, lam0: float = 1e-3,
           huber_delta: Optional[float] = None,
           solver: str = "dense",
           cg_iters: int = 100,
           cg_tol: float = 1e-6
           ) -> Tuple[BAProblem, torch.Tensor]:
    """LM loop of ``iters`` steps with multiplicative damping: a step that
    lowers the cost is kept and the damping halves (down to 1e-9), else it
    is dropped and the damping grows 4x (up to 1e6).  Runs where ``p``
    lives (``to_device``).  ``huber_delta`` (px) enables the Huber robust
    loss: IRLS-weighted steps, accept/reject and the returned cost in rho
    units.  ``solver="cg"`` selects the sparse matrix-free Schur path.
    Returns (refined problem, final cost as a 0-d float32 tensor)."""
    if p.points.device.type == "cuda":
        configure_card()
    q = p
    lam = torch.tensor(lam0, dtype=torch.float32, device=p.points.device)
    cost = robust_cost(q, huber_delta).float()
    for _ in range(iters):
        q2, cost2 = lm_step(q, lam, huber_delta=huber_delta, solver=solver,
                            cg_iters=cg_iters, cg_tol=cg_tol)
        accept = cost2 < cost
        q = q._replace(
            cam_rvec=torch.where(accept, q2.cam_rvec, q.cam_rvec),
            cam_tvec=torch.where(accept, q2.cam_tvec, q.cam_tvec),
            points=torch.where(accept, q2.points, q.points))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        cost = torch.where(accept, cost2, cost).float()
    return q, cost
