"""Chained two-view initialisation, the bundle-adjustment problem and the
trajectory error (counterpart of casmtr_tpu/sfm/reconstruct.py).

``build_problem`` assembles a ``ba.BAProblem`` on the device from a camera
chain and point tracks: the tracks' DLT triangulations in one batched
float32 call on the device (as the JAX module's ``vmap``), the
cheirality test and the padding on the host in float64 numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from casmtr_tpu_torch.serving import resolve_device
from casmtr_tpu_torch.sfm import ba as ba_mod
from casmtr_tpu_torch.sfm.geometry import (rodrigues, rotation_to_rvec,
                                           triangulate)


def chain_poses(pairwise: List[Tuple[np.ndarray, np.ndarray]]):
    """Compose a camera chain from relative poses [(R_i->i+1, t_i->i+1)].
    Returns per-camera world->cam (R, t) with camera 0 at identity."""
    Rs = [np.eye(3)]
    ts = [np.zeros(3)]
    for R_rel, t_rel in pairwise:
        Rs.append(R_rel @ Rs[-1])
        ts.append(R_rel @ ts[-1] + t_rel)
    return np.stack(Rs), np.stack(ts)


def build_problem(Rs, ts, K, tracks: Dict[int, List[Tuple[int, np.ndarray]]],
                  max_obs: Optional[int] = None,
                  device=None) -> ba_mod.BAProblem:
    """Assemble a BAProblem on ``device`` (None: the card) from a camera
    chain and point tracks.

    tracks: point_id -> [(cam_id, uv), ...] (>= 2 views each).  Points
    start at the DLT triangulation of their first two views (float32 on
    the device, the JAX module's precision).  Observations whose initial
    point lies behind (or implausibly close to) their camera are marked
    invalid.  The observations are padded with invalid zeros to
    ``max_obs``; more than that raises ValueError (the capacity keeps the
    problem's shapes those of the JAX module's, which compiles against
    it)."""
    dev = resolve_device(device)
    items = sorted(tracks.items())
    Rs_np = np.asarray(Rs, np.float64)
    ts_np = np.asarray(ts, np.float64)
    counts = np.asarray([len(views) for _, views in items], np.int64)
    obs_cam_l = np.fromiter((c for _, views in items for c, _ in views),
                            np.int64, count=int(counts.sum()))
    obs_uv_l = np.asarray([uv for _, views in items for _, uv in views],
                          np.float64).reshape(-1, 2)
    obs_pt_l = np.repeat(np.arange(len(items), dtype=np.int64), counts)
    # batched DLT from each track's first two views
    c0 = np.asarray([views[0][0] for _, views in items], np.int64)
    c1 = np.asarray([views[1][0] for _, views in items], np.int64)
    uv0 = np.asarray([views[0][1] for _, views in items], np.float64)
    uv1 = np.asarray([views[1][1] for _, views in items], np.float64)
    Pm = np.einsum("ij,cjk->cik", K,
                   np.concatenate([Rs_np, ts_np[..., None]], axis=2))
    Pm_d = torch.tensor(Pm, dtype=torch.float32, device=dev)

    def dev32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    X = triangulate(Pm_d[torch.from_numpy(c0).to(dev)],
                    Pm_d[torch.from_numpy(c1).to(dev)],
                    dev32(uv0)[:, None], dev32(uv1)[:, None])[:, 0]
    X = X.cpu().numpy()                          # the host waits here
    # per-observation cheirality against the initial point
    z = (np.einsum("nj,nj->n", Rs_np[obs_cam_l][:, 2, :],
                   X[obs_pt_l].astype(np.float64))
         + ts_np[obs_cam_l][:, 2])
    ok = np.all(np.isfinite(X), axis=1)[obs_pt_l] & (z > 1e-6)
    n = len(obs_cam_l)
    cap = max_obs or n
    if n > cap:
        raise ValueError(
            f"{n} observations exceed max_obs={cap}; raise max_obs (the "
            f"capacity the observations are padded to)")
    pad = cap - n
    valid = np.concatenate([ok, np.zeros(pad, bool)])
    obs_cam = np.concatenate([obs_cam_l, np.zeros(pad, np.int64)])
    obs_pt = np.concatenate([obs_pt_l, np.zeros(pad, np.int64)])
    obs_uv = np.concatenate(
        [obs_uv_l.astype(np.float32), np.zeros((pad, 2), np.float32)])
    rvecs = rotation_to_rvec(dev32(Rs_np))
    return ba_mod.BAProblem(
        cam_rvec=rvecs,
        cam_tvec=dev32(ts_np),
        points=torch.from_numpy(X.astype(np.float32)).to(dev),
        K=dev32(K),
        obs_cam=torch.from_numpy(obs_cam).to(dev),
        obs_pt=torch.from_numpy(obs_pt).to(dev),
        obs_uv=torch.from_numpy(obs_uv).to(dev),
        obs_valid=torch.from_numpy(valid).to(dev))


def camera_centers(p: ba_mod.BAProblem) -> np.ndarray:
    """World positions of the cameras, -R^T t (host numpy)."""
    R = rodrigues(p.cam_rvec).cpu().numpy()
    t = p.cam_tvec.cpu().numpy()
    return -np.einsum("cij,cj->ci", R.transpose(0, 2, 1), t)


def ate_rmse(centers_est: np.ndarray, centers_gt: np.ndarray) -> float:
    """Absolute trajectory error after similarity (Umeyama) alignment."""
    mu_e = centers_est.mean(0)
    mu_g = centers_gt.mean(0)
    e = centers_est - mu_e
    g = centers_gt - mu_g
    U, S, Vt = np.linalg.svd(e.T @ g / len(e))
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1, 1, d])
    R = U @ D @ Vt
    var_e = (e ** 2).sum() / len(e)
    scale = (S * np.diag(D)).sum() / max(var_e, 1e-12)
    aligned = scale * e @ R + mu_g
    return float(np.sqrt(((aligned - centers_gt) ** 2).sum(-1).mean()))
