"""Keyframe-partitioned SfM pipeline over the matcher (counterpart of
casmtr_tpu/sfm/pipeline.py).

Keyframe selection over an image sequence, pair-graph matching
partitioned across processes (``data/loader.get_local_split``) and merged
with ``parallel/comm.all_gather``, union-find track building, the chained
two-view initialisation with per-pair scale propagation and its map-based
recoveries, optional pose-graph refinement, DLT triangulation and the
Schur-complement bundle adjustment of ``sfm/ba.py``.

The matcher is a black box ``match_fn(i, j) -> (mkpts0, mkpts1, mconf)``
in pixels.  Device work (the batched relative-pose RANSAC, triangulation,
pose-graph optimisation, bundle adjustment) runs on the card unless the
caller passes ``device="cpu"``; the orchestration, the landmark maps and
the tracks are host Python, as in the JAX package.

Deviations from the JAX package:

* ``pose_solver`` defaults to ``"device"``, the batched essential-matrix
  RANSAC of ``sfm/pose.py``: the port does not use OpenCV, and ``"cv2"``
  raises NotImplementedError.
* ``_pnp_pose`` solves PnP with ``sfm/pnp.py`` (EPnP in RANSAC, host
  float64) where the JAX package calls ``cv2.solvePnPRansac``.
* ``_skip_pair_pose`` solves its single pair with ``estimate_pose_batch``
  on a batch of one where the JAX package calls OpenCV's
  ``findEssentialMat`` / ``recoverPose``.
* There is no ``_pair_pose``: the JAX package's per-pair OpenCV solve
  serves only ``pose_solver="cv2"``, which the port refuses.

Each loop marks where the host waits for the device (``# the host waits``);
``HOST_SYNCS`` counts those waits by kind.
"""

from __future__ import annotations

import warnings
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from casmtr_tpu_torch.parallel import comm
from casmtr_tpu_torch.serving import resolve_device
from casmtr_tpu_torch.sfm import ba as ba_mod
from casmtr_tpu_torch.sfm import reconstruct as Rc
from casmtr_tpu_torch.sfm.geometry import triangulate
from casmtr_tpu_torch.sfm.pnp import rodrigues, solve_pnp_ransac
from casmtr_tpu_torch.sfm.pose import estimate_pose_batch

MatchFn = Callable[[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]]
PairMatches = Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]]

NO_CV2 = ("pose_solver 'cv2' (OpenCV's per-pair RANSAC, the JAX package's "
          "default) is not ported: the port does not use OpenCV. Use "
          "pose_solver='device' (sfm.pose.estimate_pose_batch, the default "
          "here)")
HOST_SYNCS: Dict[str, int] = {"pose": 0, "triangulate": 0}
N_HYP = 512              # hypotheses per pair (estimate_pose_batch's)
POSE_CHUNK = 1 << 27     # hypothesis x match entries per solver call


def _check_solver(pose_solver: str) -> None:
    if pose_solver == "cv2":
        raise NotImplementedError(NO_CV2)
    if pose_solver != "device":
        raise ValueError(f"unknown pose solver: {pose_solver!r}")


# ---------------------------------------------------------------------------
# keyframes & pair graph
# ---------------------------------------------------------------------------

def select_keyframes(n_frames: int, match_fn: MatchFn,
                     min_matches: int = 100, max_gap: int = 8,
                     cache: Optional[PairMatches] = None) -> List[int]:
    """Adaptive keyframe selection: walk the sequence; when frame ``i``'s
    match count to the last keyframe drops below ``min_matches``, promote
    the LAST frame that still matched well and re-evaluate ``i`` against
    it; promote ``i`` directly only when no such frame exists.  A gap of
    ``max_gap`` also promotes.  Frame 0 and the last frame are always
    keyframes.  ``cache`` collects every match result keyed by
    (frame_i, frame_j), for the pair-graph matching to reuse."""
    cache = cache if cache is not None else {}
    kfs = [0]
    last_good: Optional[int] = None
    i = 1
    while i < n_frames:
        key = (kfs[-1], i)
        if key not in cache:
            cache[key] = tuple(np.asarray(a) for a in match_fn(kfs[-1], i))
        n_match = len(cache[key][0])
        if n_match < min_matches:
            if last_good is not None and last_good != kfs[-1]:
                kfs.append(last_good)   # the last well-matched frame
                last_good = None
                continue                # re-evaluate i vs the new keyframe
            kfs.append(i)
            last_good = None
        elif i - kfs[-1] >= max_gap:
            kfs.append(i)
            last_good = None
        else:
            last_good = i
        i += 1
    if kfs[-1] != n_frames - 1:
        kfs.append(n_frames - 1)
    return kfs


def pair_graph(frames: Sequence[int],
               overlaps: Sequence[int] = (1, 2)) -> List[Tuple[int, int]]:
    """Covisibility pair list: (frames[a], frames[b]) for b-a in overlaps."""
    pairs = []
    for a in range(len(frames)):
        for d in overlaps:
            if a + d < len(frames):
                pairs.append((frames[a], frames[a + d]))
    return pairs


# ---------------------------------------------------------------------------
# partitioned matching
# ---------------------------------------------------------------------------

def match_pairs(match_fn: MatchFn, pairs: Sequence[Tuple[int, int]],
                min_conf: float = 0.0, seed: int = 66,
                world: Optional[int] = None, rank: Optional[int] = None,
                gather: Callable = comm.all_gather,
                precomputed: Optional[PairMatches] = None) -> PairMatches:
    """Match a deterministic per-process slice of the pair graph and merge
    the results across processes (the first process wins on the padded
    duplicates of ``get_local_split``).  ``precomputed`` results (from
    keyframe selection) are reused instead of matching again."""
    from casmtr_tpu_torch.data.loader import get_local_split
    world = comm.get_world_size() if world is None else world
    rank = comm.get_rank() if rank is None else rank
    precomputed = precomputed or {}
    local = get_local_split(list(range(len(pairs))), world, rank, seed)
    mine: PairMatches = {}
    for pidx in local:
        i, j = pairs[int(pidx)]
        if (i, j) in mine:
            continue
        mk0, mk1, conf = precomputed.get((i, j)) or match_fn(i, j)
        keep = np.asarray(conf) >= min_conf
        mine[(i, j)] = (np.asarray(mk0)[keep], np.asarray(mk1)[keep],
                        np.asarray(conf)[keep])
    merged: PairMatches = {}
    for part in gather(mine):
        for key, val in part.items():
            merged.setdefault(key, val)
    return merged


# ---------------------------------------------------------------------------
# tracks
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self):
        self.parent: Dict = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            p = self.parent[x] = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(matches: PairMatches, quant: float = 4.0,
                 min_len: int = 2) -> Dict[int, List[Tuple[int, np.ndarray]]]:
    """Union-find track building: keypoints are identified across pairs by
    their quantised pixel cell, correspondences union the two nodes.
    Tracks seen in >= ``min_len`` distinct frames survive, with one
    observation per frame (the first, in sorted cell order)."""
    uf = _UnionFind()
    uv_of: Dict[Tuple[int, int, int], np.ndarray] = {}

    def node(frame, uv):
        key = (frame, int(uv[0] // quant), int(uv[1] // quant))
        uv_of.setdefault(key, np.asarray(uv, np.float64))
        return key

    for (i, j), (mk0, mk1, _) in matches.items():
        for a in range(len(mk0)):
            uf.union(node(i, mk0[a]), node(j, mk1[a]))
    groups: Dict = {}
    for key in uv_of:
        groups.setdefault(uf.find(key), []).append(key)
    tracks: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    tid = 0
    for members in groups.values():
        seen_frames: Dict[int, np.ndarray] = {}
        for key in sorted(members):
            frame = key[0]
            if frame not in seen_frames:
                seen_frames[frame] = uv_of[key]
        if len(seen_frames) >= min_len:
            tracks[tid] = sorted(
                (f, uv) for f, uv in seen_frames.items())
            tid += 1
    return tracks


# ---------------------------------------------------------------------------
# relative poses
# ---------------------------------------------------------------------------

def _pose_failed(i: int, j: int, n: int):
    """Failure marker (inliers None): the chain tries the map-based
    recoveries before giving up; only the exhausted case warns."""
    return np.eye(3), np.array([0.0, 0.0, 1e-3]), None


def _bucket(counts: Sequence[int]) -> int:
    """The match capacity of a batch: a multiple of 256, at least 256."""
    return max(256, int(np.ceil(max(counts) / 256.0)) * 256)


def _solve_pairs(kpts: Sequence[Tuple[np.ndarray, np.ndarray]],
                 K: np.ndarray, thresh: float, device=None, noise=None,
                 generator: Optional[torch.Generator] = None):
    """The device solver on the pairs' matches (kpts: [(mk0, mk1)]),
    padded to one bucket M: host numpy (ok [B], R [B, 3, 3], t [B, 3]
    float64, inliers [B, M], counts).  The pairs go to the solver in
    chunks of at most POSE_CHUNK hypothesis x match entries (its
    [B, 512, M] intermediates at 200 frames would not fit the card at
    once); each pair keeps its own row of ``noise`` [B, 512, M], else one
    ``generator`` (seeded 0 on the device if None) draws for all chunks."""
    dev = resolve_device(device)
    counts = [len(mk0) for mk0, _ in kpts]
    B, M = len(kpts), _bucket(counts)
    k0 = np.zeros((B, M, 2), np.float32)
    k1 = np.zeros((B, M, 2), np.float32)
    v = np.zeros((B, M), bool)
    for a, (mk0, mk1) in enumerate(kpts):
        k0[a, :counts[a]] = mk0
        k1[a, :counts[a]] = mk1
        v[a, :counts[a]] = True
    Kt = torch.tensor(np.broadcast_to(K.astype(np.float32), (B, 3, 3)),
                      device=dev)
    if noise is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    per = max(1, POSE_CHUNK // (N_HYP * M))
    parts = []
    for a in range(0, B, per):
        sl = slice(a, a + per)
        res = estimate_pose_batch(
            torch.from_numpy(k0[sl]).to(dev), torch.from_numpy(k1[sl]).to(dev),
            torch.from_numpy(v[sl]).to(dev), Kt[sl], Kt[sl],
            thr_px=float(thresh), n_hyp=N_HYP,
            noise=(None if noise is None else
                   torch.as_tensor(noise[sl]).to(dev, torch.float32)),
            generator=generator)
        HOST_SYNCS["pose"] += 1
        parts.append([x.cpu() for x in (res.ok, res.R, res.t,
                                        res.inliers)])   # the host waits
    ok, R, t, inl = (torch.cat(x).numpy() for x in zip(*parts))
    return ok, R.astype(np.float64), t.astype(np.float64), inl, counts


def _solve_one(mk0, mk1, K: np.ndarray, thresh: float, device=None,
               generator: Optional[torch.Generator] = None):
    """One pair through the device solver (a batch of one): (R, t unit,
    inlier mask) or None where it fails."""
    ok, R, t, inl, counts = _solve_pairs([(mk0, mk1)], K, thresh, device,
                                         generator=generator)
    if not ok[0]:
        return None
    return R[0], t[0], inl[0, :counts[0]]


def _pnp_pose(mk0: np.ndarray, mk1: np.ndarray,
              prev_depth: Dict[Tuple[int, int], float], K: np.ndarray,
              quant: float, thresh: float):
    """Recover the relative pose i->j by PnP RANSAC against the local map.

    The chain's scale-propagation map (``prev_depth``: frame-i cell ->
    triangulated depth at chain scale) backprojects matched frame-i
    keypoints to 3D camera-i points; ``sfm/pnp.solve_pnp_ransac`` (EPnP in
    RANSAC, its default seed) solves the frame-i -> frame-j transform from
    them and their frame-j pixels.  Well-posed under the two-view
    degeneracies (no baseline, pure rotation, a dominant plane), and t
    comes at the chain's metric scale.

    Returns (R, t, depth_j), depth_j the frame-j cell -> depth map of the
    PnP inliers in camera j, or None below 6 map hits or when PnP fails."""
    Kinv = np.linalg.inv(K)
    pts3, pts2, cells_j = [], [], []
    for idx in range(len(mk0)):
        cell = (int(mk0[idx][0] // quant), int(mk0[idx][1] // quant))
        d = prev_depth.get(cell)
        if d is not None:
            pts3.append(d * (Kinv @ np.array([mk0[idx][0], mk0[idx][1], 1.0])))
            pts2.append(np.asarray(mk1[idx], np.float64))
            cells_j.append((int(mk1[idx][0] // quant),
                            int(mk1[idx][1] // quant)))
    if len(pts3) < 6:
        return None
    pts3 = np.asarray(pts3, np.float64)
    pts2 = np.asarray(pts2, np.float64)
    ok, rvec, tvec, inl = solve_pnp_ransac(
        pts3, pts2, K.astype(np.float64),
        reprojection_error=max(2.0 * thresh, 2.0), iterations=1000,
        confidence=0.9999)
    if not ok or inl is None or len(inl) < 6:
        return None
    R = rodrigues(rvec)
    t = tvec[:, 0]
    depth_j: Dict[Tuple[int, int], float] = {}
    for row in inl[:, 0]:
        z = float((R @ pts3[row] + t)[2])
        if z > 1e-6:
            depth_j.setdefault(cells_j[row], z)
    return R, t, depth_j


def _triangulate_host(P0: np.ndarray, P1: np.ndarray, mk0: np.ndarray,
                      mk1: np.ndarray, device=None) -> np.ndarray:
    """DLT points [N, 3] of one pair, float32 on the device (the JAX
    package's precision), back on the host."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    X = triangulate(f32(P0), f32(P1), f32(mk0), f32(mk1))
    HOST_SYNCS["triangulate"] += 1
    return X.cpu().numpy()                        # the host waits here


def _skip_pair_pose(matches: PairMatches, h: int, j: int, K: np.ndarray,
                    thresh: float, quant: float,
                    depth_h: Optional[Dict[Tuple[int, int], float]],
                    rel_hi: Tuple[np.ndarray, np.ndarray], device=None,
                    generator: Optional[torch.Generator] = None):
    """Recover link i->j through the wider-baseline skip pair (h, j).

    When the consecutive pair (i, j) is degenerate, the overlap-2 pair
    (h, j) is often still solvable (the device solver on a batch of one).
    Its unit translation is rescaled against frame h's landmark map (the
    chain's median depth-ratio rule), then composed with the already
    scaled link h->i: R_ij = R_hj R_hi^T, t_ij = t_hj - R_ij t_hi.

    Returns (R_ij, t_ij, depth_j), depth_j from the (h, j) triangulation in
    camera j, or None when the pair is missing, unsolvable or unscalable."""
    if (h, j) not in matches or not depth_h:
        return None
    mk0, mk1, _ = matches[(h, j)]
    ret = _solve_one(mk0.astype(np.float64), mk1.astype(np.float64), K,
                     thresh, device, generator)
    if ret is None:
        return None
    R_hj, t_hj, inl = ret
    mk0, mk1 = mk0[inl], mk1[inl]
    if len(mk0) < 8:
        return None
    P0 = K @ np.eye(3, 4)
    P1 = K @ np.concatenate([R_hj, t_hj[:, None]], axis=1)
    X = _triangulate_host(P0, P1, mk0, mk1, device)
    ratios = []
    for idx in range(len(mk0)):
        cell = (int(mk0[idx][0] // quant), int(mk0[idx][1] // quant))
        d_prev = depth_h.get(cell)
        d_new = float(X[idx][2])
        if d_prev is not None and d_new > 1e-6:
            ratios.append(d_prev / d_new)
    if len(ratios) < 5:
        return None
    s = float(np.median(ratios))
    t_hj = s * t_hj
    R_hi, t_hi = rel_hi
    R_ij = R_hj @ R_hi.T
    t_ij = t_hj - R_ij @ t_hi
    depth_j: Dict[Tuple[int, int], float] = {}
    Xc1 = s * (X @ R_hj.T) + t_hj
    for idx in range(len(mk1)):
        if Xc1[idx][2] > 1e-6:
            cell = (int(mk1[idx][0] // quant), int(mk1[idx][1] // quant))
            depth_j.setdefault(cell, float(Xc1[idx][2]))
    return R_ij, t_ij, depth_j


def _pair_poses_device(matches: PairMatches, pairs, K: np.ndarray,
                       thresh: float, device=None, noise=None,
                       generator: Optional[torch.Generator] = None):
    """All pair poses by the batched device RANSAC
    (``sfm/pose.estimate_pose_batch``; one call, or chunks of pairs when
    the batch is large), the matches padded to a 256-multiple bucket M.
    ``noise`` [len(pairs), 512, M] is the hypotheses' draw (e.g. another
    implementation's), else ``generator`` draws it (seeded 0 on the device
    if None)."""
    ok, Rs, ts, inl, counts = _solve_pairs(
        [matches[p][:2] for p in pairs], K, thresh, device, noise, generator)
    out = []
    for a, (i, j) in enumerate(pairs):
        if ok[a]:
            out.append((Rs[a], ts[a], inl[a, :counts[a]]))
        else:
            out.append(_pose_failed(i, j, counts[a]))
    return out


def pair_relative_poses(matches: PairMatches, pairs, K: np.ndarray,
                        thresh: float = 0.5, pose_solver: str = "device",
                        device=None, noise=None,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[Tuple[int, int], tuple]:
    """Relative pose (R, t unit, inlier mask or None on failure) of every
    pair, by the batched device solver (``_pair_poses_device``)."""
    _check_solver(pose_solver)
    pairs = list(pairs)
    return dict(zip(pairs, _pair_poses_device(matches, pairs, K, thresh,
                                              device, noise, generator)))


def chain_with_scale(matches: PairMatches, frames: Sequence[int],
                     K: np.ndarray, thresh: float = 0.5, quant: float = 4.0,
                     pose_solver: str = "device",
                     pair_poses: Optional[Dict[Tuple[int, int], tuple]]
                     = None, device=None, noise=None,
                     generator: Optional[torch.Generator] = None):
    """Monocular incremental chain: consecutive relative poses, each pair's
    unit translation rescaled so that the depths of the keypoints pair
    (a, b) and pair (b, c) share agree in frame b (median depth ratio); the
    first pair sets the global scale.

    The consecutive pairs' poses come from ``pair_poses`` when given, else
    from the batched device solver (``noise`` [len(frames)-1, 512, M]
    feeds its draw).  A failed link recovers from the map: (1) PnP RANSAC
    against the propagated landmark map (``_pnp_pose``), (2) composition
    through the overlap-2 pair (frames[a-1], j) when it was matched
    (``_skip_pair_pose``).  Only when both fail does a near-identity link
    remain, with the "trajectory unreliable" warning."""
    _check_solver(pose_solver)
    rel: List[Tuple[np.ndarray, np.ndarray]] = []
    # per-frame landmark maps (quantised cell -> chain-scale depth), read by
    # scale propagation (frame i's map) and by the recoveries
    frame_depth: Dict[int, Dict[Tuple[int, int], float]] = {}
    if pair_poses is not None:
        device_poses = [pair_poses[(frames[a], frames[a + 1])]
                        for a in range(len(frames) - 1)]
    else:
        consecutive = [(frames[a], frames[a + 1])
                       for a in range(len(frames) - 1)]
        device_poses = _pair_poses_device(matches, consecutive, K, thresh,
                                          device, noise, generator)
    for a in range(len(frames) - 1):
        i, j = frames[a], frames[a + 1]
        R, t, inl = device_poses[a]
        mk0, mk1, _ = matches[(i, j)]
        prev_depth = frame_depth.get(i)
        metric = False                 # t already at chain scale (recovery)
        depth_j: Optional[Dict[Tuple[int, int], float]] = None
        if inl is None:
            rec = (_pnp_pose(mk0, mk1, prev_depth, K, quant, thresh)
                   if prev_depth else None)
            if rec is not None:
                R, t, depth_j = rec
                metric = True
            else:
                rec2 = (_skip_pair_pose(matches, frames[a - 1], j, K, thresh,
                                        quant, frame_depth.get(frames[a - 1]),
                                        rel[-1], device, generator)
                        if a > 0 else None)
                if rec2 is not None:
                    R, t, depth_j = rec2
                    metric = True
                else:
                    warnings.warn(
                        f"RANSAC pose failed for keyframe pair ({i}, {j}) "
                        f"({len(mk0)} matches) and no map recovery was "
                        "possible — inserting a near-identity fallback; "
                        f"the trajectory past frame {i} is unreliable",
                        RuntimeWarning)
        else:
            mk0, mk1 = mk0[inl], mk1[inl]
        # one DLT pass per pair at unit baseline; depths scale linearly with
        # the baseline, so the rescaled cam-1 points are scale * (X R^T + t)
        X = None
        if len(mk0) > 0 and depth_j is None:
            P0 = K @ np.eye(3, 4)
            P1 = K @ np.concatenate([R, t[:, None]], axis=1)
            X = _triangulate_host(P0, P1, mk0, mk1, device)
        scale = 1.0
        if not metric and prev_depth and X is not None and len(mk0) >= 8:
            # shared cells in frame i: the previous pair's cam-j is this
            # pair's cam-i; compare this pair's cam-i depths to them
            ratios = []
            for idx in range(len(mk0)):
                cell = (int(mk0[idx][0] // quant), int(mk0[idx][1] // quant))
                d_prev = prev_depth.get(cell)
                d_new = float(X[idx][2])
                if d_prev is not None and d_new > 1e-6:
                    ratios.append(d_prev / d_new)
            if len(ratios) >= 5:
                scale = float(np.median(ratios))
        t = t * scale
        rel.append((R, t))
        if depth_j is not None:
            frame_depth[j] = depth_j
        else:
            frame_depth[j] = {}
            if X is not None:
                Xc1 = scale * (X @ R.T) + t  # == (scale X) R^T + t_scaled
                for idx in range(len(mk1)):
                    if Xc1[idx][2] > 1e-6:
                        cell = (int(mk1[idx][0] // quant),
                                int(mk1[idx][1] // quant))
                        frame_depth[j].setdefault(cell, float(Xc1[idx][2]))
                # augment frame i's map with this pair's cam-i depths (the
                # skip-pair recovery two links later reads it)
                fi = frame_depth.setdefault(i, {})
                for idx in range(len(mk0)):
                    z = float(scale * X[idx][2])
                    if z > 1e-6:
                        cell = (int(mk0[idx][0] // quant),
                                int(mk0[idx][1] // quant))
                        fi.setdefault(cell, z)
    return Rc.chain_poses(rel)


# ---------------------------------------------------------------------------
# pose-graph refinement (rotation + translation/scale averaging)
# ---------------------------------------------------------------------------

def refine_with_pose_graph(Rs: np.ndarray, ts: np.ndarray,
                           pair_poses: Dict[Tuple[int, int], tuple],
                           keyframes: Sequence[int],
                           rot_iters: int = 8, trans_rounds: int = 4,
                           device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Distribute the chain's drift over ALL matched pairs
    (``sfm/pose_graph.py``, float32 on the device): failed pairs give no
    edge, edges weigh sqrt(inlier count).  Returns the input unchanged
    when the graph has no edge beyond the chain's, and the averaged
    rotations with the chain's translations when the edge directions are
    (near-)collinear (translation averaging would trade the chain's depth-
    propagated spacing for direction noise)."""
    from casmtr_tpu_torch.sfm.pose_graph import (PoseGraph,
                                                 average_rotations,
                                                 average_translations)
    kf_index = {f: a for a, f in enumerate(keyframes)}
    ei, ej, Rr, tr, w = [], [], [], [], []
    for (i, j), (R, t, inl) in pair_poses.items():
        if inl is None or i not in kf_index or j not in kf_index:
            continue
        n = np.linalg.norm(np.asarray(t))
        ei.append(kf_index[i])
        ej.append(kf_index[j])
        Rr.append(np.asarray(R, np.float32))
        tr.append(np.asarray(t, np.float32) / max(float(n), 1e-12))
        w.append(np.sqrt(max(int(np.sum(inl)), 1)))
    # a chain has C-1 edges; PGO needs redundant ones to say anything new
    if len(ei) < len(keyframes):
        return Rs, ts
    dev = resolve_device(device)
    wn = np.asarray(w, np.float32)
    g = PoseGraph(torch.tensor(ei, dtype=torch.int64, device=dev),
                  torch.tensor(ej, dtype=torch.int64, device=dev),
                  torch.from_numpy(np.stack(Rr)).to(dev),
                  torch.from_numpy(np.stack(tr)).to(dev),
                  torch.from_numpy(wn / wn.max()).to(dev))
    R2 = average_rotations(torch.tensor(Rs, dtype=torch.float32, device=dev),
                           g, iters=rot_iters)
    R2_np = R2.cpu().numpy()                      # the host waits here
    # translation-averaging degeneracy gate: the world direction of edge
    # (i, j) is -R_j^T t_rel; skip when the direction cloud's second
    # singular value is under a tenth of the first (uncentred on purpose:
    # +d and -d are the same bearing constraint)
    dirs = np.stack([R2_np[j].T @ d for j, d in zip(ej, np.stack(tr))])
    sv = np.linalg.svd(dirs, compute_uv=False)
    if sv[1] < 0.1 * sv[0]:
        return np.asarray(R2_np, np.float64), np.asarray(ts, np.float64)
    t2, _ = average_translations(
        R2, torch.tensor(ts, dtype=torch.float32, device=dev), g,
        rounds=trans_rounds)
    return (np.asarray(R2_np, np.float64),
            t2.cpu().numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

class SfMResult(NamedTuple):
    keyframes: List[int]
    matches: PairMatches
    tracks: Dict[int, List[Tuple[int, np.ndarray]]]
    problem: ba_mod.BAProblem          # refined (after BA), on the device
    init_Rs: np.ndarray                # chain init, world->cam
    init_ts: np.ndarray
    cost: float                        # final BA cost (rho units, px^2)


def reconstruct_sequence(match_fn: MatchFn, n_frames: int, K: np.ndarray,
                         keyframes: Optional[Sequence[int]] = None,
                         min_matches: int = 100, max_gap: int = 8,
                         overlaps: Sequence[int] = (1, 2),
                         min_conf: float = 0.0, ransac_thresh: float = 0.5,
                         quant: float = 4.0, min_track_len: int = 2,
                         ba_iters: int = 20, huber_delta: float = 3.0,
                         max_obs: Optional[int] = None,
                         pose_solver: str = "device",
                         pgo: bool = False,
                         solver: str = "auto",
                         cg_iters: int = 100, device=None, noise=None,
                         generator: Optional[torch.Generator] = None
                         ) -> SfMResult:
    """End to end: keyframes -> partitioned pair matching -> chained init
    with scale propagation -> (``pgo``: pose-graph refinement over all
    matched pairs) -> tracks -> triangulation -> robust Schur BA (Huber,
    ``huber_delta`` px; None for plain least squares).  ``solver``:
    "auto" takes the sparse CG path when P*C > 3e6, else the dense direct
    solve.  Device work on ``device`` (None: the card).  ``noise`` is the
    device solver's draw for its batch: all pairs under ``pgo``, else the
    consecutive keyframe pairs."""
    _check_solver(pose_solver)
    if 1 not in overlaps:
        raise ValueError("overlaps must include 1: the chained "
                         "initialization needs every consecutive keyframe "
                         f"pair (got {tuple(overlaps)})")
    dev = resolve_device(device)
    cache: PairMatches = {}
    if keyframes is None:
        keyframes = select_keyframes(n_frames, match_fn,
                                     min_matches=min_matches,
                                     max_gap=max_gap, cache=cache)
    keyframes = list(keyframes)
    pairs = pair_graph(keyframes, overlaps)
    matches = match_pairs(match_fn, pairs, min_conf=min_conf,
                          precomputed=cache)
    pair_poses = None
    if pgo:
        pair_poses = pair_relative_poses(matches, pairs, K,
                                         thresh=ransac_thresh,
                                         pose_solver=pose_solver, device=dev,
                                         noise=noise, generator=generator)
        noise = None
    Rs, ts = chain_with_scale(matches, keyframes, K, thresh=ransac_thresh,
                              quant=quant, pose_solver=pose_solver,
                              pair_poses=pair_poses, device=dev, noise=noise,
                              generator=generator)
    if pgo:
        Rs, ts = refine_with_pose_graph(Rs, ts, pair_poses, keyframes,
                                        device=dev)
    kf_index = {f: a for a, f in enumerate(keyframes)}
    raw_tracks = build_tracks(matches, quant=quant, min_len=min_track_len)
    tracks = {tid: [(kf_index[f], uv) for f, uv in views]
              for tid, views in raw_tracks.items()}
    if not tracks:
        raise ValueError("no tracks survived — matcher produced too few "
                         "consistent matches")
    problem = Rc.build_problem(Rs, ts, K, tracks, max_obs=max_obs,
                               device=dev)
    if solver == "auto":
        pc = problem.points.shape[0] * problem.cam_rvec.shape[0]
        solver = "cg" if pc > 3e6 else "dense"
    refined, cost = ba_mod.run_ba(problem, iters=ba_iters,
                                  huber_delta=huber_delta, solver=solver,
                                  cg_iters=cg_iters)
    return SfMResult(keyframes=keyframes, matches=matches,
                     tracks=raw_tracks, problem=refined,
                     init_Rs=Rs, init_ts=ts, cost=float(cost))


def model_match_fn(cfg, model: torch.nn.Module, paths: Sequence[str],
                   resize: int = 640, thr: float = 0.2,
                   device=None) -> MatchFn:
    """The full matcher (``cli/match_pair.make_matcher``: ``model`` of
    ``cfg.loftr`` on ``device``, None the card) as the pipeline's
    ``match_fn(i, j)`` over a list of image paths."""
    from casmtr_tpu_torch.cli.match_pair import make_matcher
    matcher = make_matcher(cfg, model, resize=resize, thr=thr, device=device)

    def fn(i: int, j: int):
        return matcher(paths[i], paths[j])

    return fn
