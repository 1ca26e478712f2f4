"""The port's SfM engine against the JAX package's, on the CPU, on the same
numpy inputs made from seeds:

* ``sfm/geometry.py``: ``rodrigues``, ``rotation_to_rvec`` (the pi branch
  too) and ``project`` within 1e-5; ``triangulate`` within 1e-4 relative
  on noiseless views; the Jacobian of ``rodrigues`` at rvec = 0 finite and
  within 1e-5 of JAX's (the select-on-input small-angle branch);
* ``sfm/ba.py`` on tests/test_sfm.make_problem: ``_jacobians`` within 1e-5
  of the largest entry (they reach 413 px/rad, where a float32 ulp is
  3e-5, so an absolute 1e-5 cannot hold); ``run_ba`` dense with and
  without Huber, final cost within 1e-4 relative, the parameters within
  1e-4 absolute plus 1e-4 relative, translations and points once each
  side is divided by its own translation norm (the monocular scale is a
  near-null direction of
  the problem: the port's float32 and float64 runs part by 7e-3 in raw
  translations at costs equal to 2e-6); CG with and without Huber, cost
  within 1e-3 relative (its float32 matvec stalls CG at ~1e-3);
* ``sfm/pose_graph.py``: ``average_rotations``, ``average_translations``
  and ``optimize_pose_graph`` on tests/test_pose_graph.py's graphs within
  1e-4;
* ``sfm/reconstruct.py``: ``build_problem`` (valid mask, capacity,
  padding exactly, points within 1e-4 relative, the ``max_obs``
  ValueError), ``camera_centers`` within 1e-5 and ``ate_rmse`` within
  1e-6;
* ``sfm/pnp.py`` against OpenCV: ``epnp`` against ``cv2.solvePnP(...,
  SOLVEPNP_EPNP)`` on the same points, equal within 1e-10 on noiseless
  points; under 0.5 px noise on 1000 points two fits of equal quality
  (sums of squared reprojection errors within 2% of each other),
  rotations within 1e-3 and translations within 1e-2 of each other over
  20 scenes (``epnp_gap``: at most 5.2e-4 and 4.5e-3; OpenCV 5.0's EPnP
  is not the classic fit of Lepetit et al. that sfm/pnp.py implements).  ``solve_pnp_ransac`` against
  ``cv2.solvePnPRansac(..., SOLVEPNP_EPNP)``: with 20% gross outliers on
  noiseless points both within 1e-6 of the truth with the same inlier
  set; under 0.5 px noise on 1000 points neither keeps an outlier, the
  inlier sets part by at most 2% of the points, each output is its own
  EPnP on its inliers, and refitted on the common inliers the two part as
  the direct fits do (rotations 1e-3, translations 5e-3): the gap is the
  fit's, not the inlier sets'.  Each translation within 5e-3 of the
  truth;
* ``parallel/comm.py`` in one process, and the device rule: without CUDA
  a problem sent to the card, ``build_problem`` and
  ``pipeline.reconstruct_sequence`` on the default device raise, and
  ``pose_solver="cv2"`` raises naming the device solver.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.sfm import ba as JB  # noqa: E402
from casmtr_tpu.sfm import geometry as JG  # noqa: E402
from casmtr_tpu.sfm import pose_graph as JPG  # noqa: E402
from casmtr_tpu.sfm import reconstruct as JR  # noqa: E402
from casmtr_tpu_torch.sfm import ba as TB  # noqa: E402
from casmtr_tpu_torch.sfm import geometry as TG  # noqa: E402
from casmtr_tpu_torch.sfm import pose_graph as TPG  # noqa: E402
from casmtr_tpu_torch.sfm import reconstruct as TR  # noqa: E402
from tests import test_pose_graph as PGT  # noqa: E402
from tests.test_sfm import make_problem, synth_scene  # noqa: E402
from tests.torch_parity import fast_jit  # noqa: E402

GEOM_ATOL = 1e-5
TRI_RTOL = 1e-4
JAC_REL = 1e-5
COST_RTOL = 1e-4
CG_COST_RTOL = 1e-3
PARAM_ATOL = 1e-4
PG_ATOL = 1e-4


def to_torch(tree, cls):
    """A NamedTuple of jnp arrays as the port's (int64 indices)."""
    out = []
    for x in tree:
        a = np.array(x)
        t = torch.from_numpy(a)
        out.append(t.long() if a.dtype.kind == "i" else t)
    return cls(*out)


def np_of(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------------- geometry

def test_rodrigues_project_and_rvec_match_jax():
    rng = np.random.default_rng(0)
    rv = np.concatenate([rng.standard_normal((20, 3)) * 0.7,
                         rng.standard_normal((3, 3)) * 1e-7,
                         np.zeros((1, 3))]).astype(np.float32)
    Rj = np.asarray(jax.vmap(JG.rodrigues)(jnp.asarray(rv)))
    Rt = TG.rodrigues(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=GEOM_ATOL, rtol=0)
    back_j = np.asarray(jax.vmap(JG.rotation_to_rvec)(jnp.asarray(Rj)))
    back_t = TG.rotation_to_rvec(torch.from_numpy(Rj)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=GEOM_ATOL, rtol=0)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    X = np.stack([rng.uniform(-2, 2, 30), rng.uniform(-1.5, 1.5, 30),
                  rng.uniform(5, 9, 30)], -1).astype(np.float32)
    tv = (rng.standard_normal(3) * 0.3).astype(np.float32)
    uv_j = np.asarray(JG.project(jnp.asarray(rv[0] * 0.1), jnp.asarray(tv),
                                 jnp.asarray(X), jnp.asarray(K)))
    uv_t = TG.project(torch.from_numpy(rv[0] * 0.1), torch.from_numpy(tv),
                      torch.from_numpy(X), torch.from_numpy(K)).numpy()
    # pixels near 300: a float32 ulp is 3e-5; 1e-5 relative to the scale
    np.testing.assert_allclose(uv_t, uv_j, atol=GEOM_ATOL * 400, rtol=0)


@pytest.mark.parametrize("axis", ([1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                                  [0.6, 0.8, 0.0], [0.36, 0.48, 0.8]))
def test_rotation_to_rvec_pi_branch_matches_jax(axis):
    """theta ~ pi: both recover the rotation, and the same vector."""
    rv = (np.pi * np.asarray(axis)).astype(np.float32)
    R = np.asarray(JG.rodrigues(jnp.asarray(rv)))
    vj = np.asarray(JG.rotation_to_rvec(jnp.asarray(R)))
    vt = TG.rotation_to_rvec(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(vt, vj, atol=GEOM_ATOL, rtol=0)
    np.testing.assert_allclose(TG.rodrigues(torch.from_numpy(vt)).numpy(),
                               R, atol=GEOM_ATOL, rtol=0)


def test_rodrigues_jacobian_at_zero_is_finite_and_jax():
    z = np.zeros(3, np.float32)
    Jj = np.asarray(jax.jacfwd(JG.rodrigues)(jnp.asarray(z)))
    Jt = torch.func.jacfwd(TG.rodrigues)(torch.from_numpy(z)).numpy()
    assert np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt, Jj, atol=GEOM_ATOL, rtol=0)
    # and through BA's residual at camera 0 (rvec 0)
    p = make_problem(np.random.default_rng(1))
    p = p._replace(cam_rvec=p.cam_rvec.at[0].set(0.0))
    tp = to_torch(p, TB.BAProblem)
    _, Jc, _ = TB._jacobians(tp)
    assert torch.isfinite(Jc).all()


def test_triangulate_matches_jax_and_truth():
    rng = np.random.default_rng(2)
    rvecs, tvecs, pts, K, _, _, ouv = synth_scene(rng, C=2, P=20)
    Ps = [K @ np.concatenate([np.asarray(JG.rodrigues(jnp.asarray(r))),
                              t[:, None]], 1) for r, t in zip(rvecs, tvecs)]
    args = (Ps[0], Ps[1], ouv[:20], ouv[20:40])
    Xj = np.asarray(JG.triangulate(*map(jnp.asarray, args)))
    Xt = TG.triangulate(*(torch.tensor(np.asarray(a), dtype=torch.float32)
                          for a in args)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=TRI_RTOL, atol=0)
    np.testing.assert_allclose(Xt, pts, rtol=TRI_RTOL, atol=0)
    # degenerate (no baseline): finite points
    Xd = TG.triangulate(torch.tensor(Ps[0], dtype=torch.float32),
                        torch.tensor(Ps[0], dtype=torch.float32),
                        torch.tensor(ouv[:5]), torch.tensor(ouv[:5]))
    assert torch.isfinite(Xd).all()


# --------------------------------------------------------------------- BA

@pytest.fixture(scope="module")
def problem():
    return make_problem(np.random.default_rng(0))


@pytest.fixture(scope="module")
def jax_runs(problem):
    """One JAX run per (solver, Huber) configuration, as tests/test_sfm.py
    runs them (its scan compiled by XLA's default pipeline: fast_jit's
    unoptimised compile moves the gauge-free points by 1.7e-4 relative,
    the problem's own float32 sensitivity there)."""
    return {(s, h): JB.run_ba(problem, iters=10, huber_delta=h, solver=s)
            for s in ("dense", "cg") for h in (None, 2.0)}


@pytest.mark.parametrize("huber", (None, 2.0))
def test_jacobians_match_jax(problem, huber):
    want = fast_jit(lambda q: JB._jacobians(q, huber))(problem)
    got = TB._jacobians(to_torch(problem, TB.BAProblem), huber)
    for w, g in zip(want, got):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=JAC_REL * scale,
                                   rtol=0)


def _gauge_free(q):
    """(rotations, translations and points over the translation norm)."""
    t = np_of(q.cam_tvec)
    s = np.linalg.norm(t)
    return np_of(q.cam_rvec), t / s, np_of(q.points) / s


@pytest.mark.parametrize("solver", ("dense", "cg"))
@pytest.mark.parametrize("huber", (None, 2.0))
def test_run_ba_matches_jax(problem, jax_runs, solver, huber):
    qj, cj = jax_runs[solver, huber]
    qt, ct = TB.run_ba(to_torch(problem, TB.BAProblem), iters=10,
                       huber_delta=huber, solver=solver)
    assert ct.dtype == torch.float32 and ct.dim() == 0
    c0 = float(JB.robust_cost(problem, huber))
    assert float(ct) < 0.05 * c0
    if solver == "dense":
        np.testing.assert_allclose(float(ct), float(cj), rtol=COST_RTOL)
        for a, b in zip(_gauge_free(qt), _gauge_free(qj)):
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL,
                                       rtol=PARAM_ATOL)
    else:
        np.testing.assert_allclose(float(ct), float(cj), rtol=CG_COST_RTOL)


def test_ba_sparse_cg_duplicates_and_pcg_syncs():
    """tests/test_sfm.py's duplicated observations under Huber: the port's
    CG against its dense solve (cost within 1e-4 relative); the PCG loop
    reads its stop rule once per iteration (at most cg_iters per step)."""
    p = make_problem(np.random.default_rng(3), noise=0.4, C=4, P=50)
    sl = slice(0, 40)
    p = p._replace(
        obs_cam=jnp.concatenate([p.obs_cam, p.obs_cam[sl]]),
        obs_pt=jnp.concatenate([p.obs_pt, p.obs_pt[sl]]),
        obs_uv=jnp.concatenate([p.obs_uv, p.obs_uv[sl]]),
        obs_valid=jnp.concatenate([p.obs_valid, p.obs_valid[sl]]))
    tp = to_torch(p, TB.BAProblem)
    _, c_d = TB.run_ba(tp, iters=6, huber_delta=2.0)
    before = TB.HOST_SYNCS["pcg"]
    _, c_s = TB.run_ba(tp, iters=6, huber_delta=2.0, solver="cg",
                       cg_iters=200, cg_tol=1e-8)
    syncs = TB.HOST_SYNCS["pcg"] - before
    np.testing.assert_allclose(float(c_s), float(c_d), rtol=1e-4)
    assert 6 <= syncs <= 6 * 200


# ------------------------------------------------------------- pose graph

def _graph(g):
    return to_torch(g, TPG.PoseGraph)


def test_average_rotations_match_jax():
    rng = np.random.default_rng(0)
    Rs, ts = PGT.make_trajectory(10, rng)
    g = PGT.graph_from_gt(Rs, ts, PGT.skip_edges(10), rng)
    R0, _ = PGT.drifted_init(Rs, ts, rng)
    # with a gross outlier edge (the trimmed IRLS path)
    Rbad = np.asarray(g.R_rel).copy()
    Rbad[5] = PGT._rot([0.0, 1.05, 0.0]) @ Rbad[5]
    for graph in (g, g._replace(R_rel=jnp.asarray(Rbad))):
        Rj = np.asarray(fast_jit(JPG.average_rotations)(
            jnp.asarray(R0, jnp.float32), graph))
        Rt = TPG.average_rotations(torch.tensor(R0, dtype=torch.float32),
                                   _graph(graph)).numpy()
        np.testing.assert_allclose(Rt, Rj, atol=PG_ATOL, rtol=0)
        np.testing.assert_allclose(Rt[0], Rs[0], atol=1e-5)


def test_average_translations_match_jax():
    rng = np.random.default_rng(1)
    Rs, ts = PGT.make_trajectory(8, rng)
    g = PGT.graph_from_gt(Rs, ts, PGT.skip_edges(8), rng)
    _, t0 = PGT.drifted_init(Rs, ts, rng, rot_drift=0.0, t_drift=0.1)
    tj, sj = fast_jit(JPG.average_translations)(
        jnp.asarray(Rs, jnp.float32), jnp.asarray(t0, jnp.float32), g)
    tt, st = TPG.average_translations(torch.tensor(Rs, dtype=torch.float32),
                                      torch.tensor(t0, dtype=torch.float32),
                                      _graph(g))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=PG_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=PG_ATOL)


def test_optimize_pose_graph_matches_jax():
    rng = np.random.default_rng(2)
    C = 14
    Rs, ts = PGT.make_trajectory(C, rng, turn=2 * np.pi / C)
    edges = PGT.skip_edges(C, (1, 2)) + [(0, C - 1), (0, C // 2)]
    g = PGT.graph_from_gt(Rs, ts, edges, rng, rot_noise=0.002,
                          dir_noise=0.002)
    R0, t0 = PGT.drifted_init(Rs, ts, rng, rot_drift=0.03, t_drift=0.15)
    Rj, tj = fast_jit(JPG.optimize_pose_graph)(
        jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32), g)
    Rt, tt = TPG.optimize_pose_graph(torch.tensor(R0, dtype=torch.float32),
                                     torch.tensor(t0, dtype=torch.float32),
                                     _graph(g))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=PG_ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=PG_ATOL)


# ------------------------------------------------------------ reconstruct

def _chain_tracks(rng):
    """tests/test_sfm.py's chain scene: a noisy chain and 4-view tracks."""
    rvecs, tvecs, pts, K, _, _, ouv = synth_scene(rng, C=4, P=60, noise=0.3)
    pairwise = []
    for c in range(3):
        R0 = np.asarray(JG.rodrigues(jnp.asarray(rvecs[c])))
        R1 = np.asarray(JG.rodrigues(jnp.asarray(rvecs[c + 1])))
        R_rel = R1 @ R0.T
        pairwise.append((R_rel, tvecs[c + 1] - R_rel @ tvecs[c]
                         + rng.normal(0, 0.01, 3)))
    tracks = {pid: [(c, ouv[c * 60 + pid]) for c in range(4)]
              for pid in range(60)}
    return pairwise, tracks, K, rvecs, tvecs


def test_build_problem_centers_and_ate_match_jax():
    pairwise, tracks, K, rvecs, tvecs = _chain_tracks(
        np.random.default_rng(4))
    Rs_j, ts_j = JR.chain_poses(pairwise)
    Rs_t, ts_t = TR.chain_poses(pairwise)
    np.testing.assert_array_equal(Rs_t, Rs_j)
    np.testing.assert_array_equal(ts_t, ts_j)
    pj = JR.build_problem(Rs_j, ts_j, K, tracks, max_obs=256)
    pt = TR.build_problem(Rs_t, ts_t, K, tracks, max_obs=256, device="cpu")
    assert pt.obs_valid.shape == (256,)
    for f in ("obs_valid", "obs_cam", "obs_pt", "obs_uv"):
        np.testing.assert_array_equal(np_of(getattr(pt, f)),
                                      np.asarray(getattr(pj, f)))
    np.testing.assert_allclose(pt.points.numpy(), np.asarray(pj.points),
                               rtol=TRI_RTOL, atol=0)
    for f in ("cam_rvec", "cam_tvec", "K"):
        np.testing.assert_allclose(np_of(getattr(pt, f)),
                                   np.asarray(getattr(pj, f)), atol=GEOM_ATOL)
    cj, ct = JR.camera_centers(pj), TR.camera_centers(pt)
    np.testing.assert_allclose(ct, cj, atol=GEOM_ATOL)
    gt = np.stack([-np.asarray(JG.rodrigues(jnp.asarray(r))).T @ t
                   for r, t in zip(rvecs, tvecs)])
    assert abs(TR.ate_rmse(ct, gt) - JR.ate_rmse(cj, gt)) <= 1e-6


def test_build_problem_cheirality_and_capacity():
    """tests/test_sfm.py's case: a track whose views are crossed lands
    behind the camera and is masked in both; over capacity raises."""
    K = np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]])
    Rs = np.stack([np.eye(3), np.eye(3)])
    ts = np.stack([np.zeros(3), np.array([-0.5, 0, 0])])
    front = [(0, np.array([45.0, 30.0])), (1, np.array([40.0, 30.0]))]
    X = np.array([0.3, 0.0, 5.0])
    uv0 = (K @ X)[:2] / X[2]
    X1 = Rs[1] @ X + ts[1]
    uv1 = (K @ X1)[:2] / X1[2]
    tracks = {0: front, 1: [(0, uv1), (1, uv0)]}
    pj = JR.build_problem(Rs, ts, K, tracks)
    pt = TR.build_problem(Rs, ts, K, tracks, device="cpu")
    np.testing.assert_array_equal(pt.obs_valid.numpy(),
                                  np.asarray(pj.obs_valid))
    assert pt.obs_valid[:2].all() and not pt.obs_valid[2:4].all()
    with pytest.raises(ValueError, match="max_obs"):
        TR.build_problem(Rs, ts, K, {0: front}, max_obs=1, device="cpu")


# -------------------------------------------------------------------- PnP

def _pnp_scene(rng, n, noise, outlier_share=0.2):
    from casmtr_tpu_torch.sfm.pnp import rodrigues
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(5, 10, n)], -1)
    rv, tv = rng.normal(0, 0.1, 3), rng.normal(0, 0.3, 3)
    Xc = X @ rodrigues(rv).T + tv
    uv = Xc @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    bad = rng.choice(n, int(n * outlier_share), replace=False)
    uv[bad] += (rng.uniform(20, 80, (len(bad), 2))
                * rng.choice([-1, 1], (len(bad), 2)))
    uv = uv + rng.normal(0, noise, uv.shape) if noise else uv
    return X, uv, K, rodrigues(rv), tv, bad


def _both_pnp(X, uv, K):
    import cv2
    from casmtr_tpu_torch.sfm.pnp import rodrigues, solve_pnp_ransac
    kw = dict(reprojectionError=2.0, iterationsCount=1000,
              confidence=0.9999)
    ok_c, rv_c, tv_c, inl_c = cv2.solvePnPRansac(
        X, uv, K, None, flags=cv2.SOLVEPNP_EPNP, **kw)
    ok_p, rv_p, tv_p, inl_p = solve_pnp_ransac(
        X, uv, K, reprojection_error=2.0, iterations=1000, confidence=0.9999)
    assert ok_c and ok_p
    assert rv_p.shape == (3, 1) and tv_p.shape == (3, 1)
    assert inl_p.shape[1] == 1 and inl_p.dtype == np.int32
    return ((rodrigues(rv_p), tv_p[:, 0], inl_p),
            (cv2.Rodrigues(rv_c)[0], tv_c[:, 0], inl_c))


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_pnp_noiseless_outliers_match_truth_and_cv2(seed):
    pytest.importorskip("cv2")
    X, uv, K, R, t, bad = _pnp_scene(np.random.default_rng(seed), 80, 0.0)
    port, ref = _both_pnp(X, uv, K)
    for Rg, tg, _ in (port, ref):
        np.testing.assert_allclose(Rg, R, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tg, t, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port[2], ref[2])
    np.testing.assert_array_equal(port[2][:, 0],
                                  np.setdiff1d(np.arange(80), bad))


def _cv2_epnp(X, uv, K):
    import cv2
    ok, rv, tv = cv2.solvePnP(X, uv, K, None, flags=cv2.SOLVEPNP_EPNP)
    assert ok
    return cv2.Rodrigues(rv)[0], tv[:, 0]


def epnp_gap(seed):
    """The two EPnP fits of one scene's 1000 points at 0.5 px, without
    outliers: (max |R_port - R_cv2|, max |t_port - t_cv2|, the port's sum
    of squared reprojection errors over OpenCV's, whether the port's t is
    the nearer to the truth).  Over seeds 0-19, from the repository's
    root: PYTHONPATH=.:tests python -c 'from tests.test_torch_sfm import
    epnp_gap; print([epnp_gap(s) for s in range(20)])'."""
    from casmtr_tpu_torch.sfm.pnp import _sq_errors, epnp
    X, uv, K, R, t, _ = _pnp_scene(np.random.default_rng(seed), 1000, 0.5,
                                   outlier_share=0.0)
    Rp, tp, _ = epnp(X, uv, K)
    Rc, tc = _cv2_epnp(X, uv, K)
    sse = (_sq_errors(Rp, tp, X, uv, K).sum()
           / _sq_errors(Rc, tc, X, uv, K).sum())
    return (float(np.abs(Rp - Rc).max()), float(np.abs(tp - tc).max()),
            float(sse), bool(np.abs(tp - t).max() < np.abs(tc - t).max()))


@pytest.mark.parametrize("seed", range(20))
def test_epnp_fit_against_cv2_epnp(seed):
    """The two EPnP fits of the same points, without outliers: equal on
    noiseless points; under 0.5 px noise different but equally good."""
    pytest.importorskip("cv2")
    from casmtr_tpu_torch.sfm.pnp import epnp
    X, uv, K, R, t, _ = _pnp_scene(np.random.default_rng(seed), 60, 0.0,
                                   outlier_share=0.0)
    Rp, tp, _ = epnp(X, uv, K)
    Rc, tc = _cv2_epnp(X, uv, K)
    for Rg, tg in ((Rp, tp), (Rc, tc)):
        np.testing.assert_allclose(Rg, R, atol=1e-10, rtol=0)
        np.testing.assert_allclose(tg, t, atol=1e-10, rtol=0)
    d_R, d_t, sse, _ = epnp_gap(seed)
    assert d_R < 1e-3 and d_t < 1e-2
    assert abs(sse - 1.0) < 0.02


def _noisy_ransac_check(seed):
    """Under 0.5 px noise on 1000 points with 20% gross outliers: the
    rotations within 1e-3 of each other, each translation within 5e-3 of
    the truth; no outlier kept, the inlier sets within 2% of the points of
    each other; each output its own EPnP on its inliers (OpenCV's within
    1e-6: its RANSAC rounds the points to float32); refitted on the common
    inliers, the two fits part by no more than the direct fits do."""
    pytest.importorskip("cv2")
    from casmtr_tpu_torch.sfm.pnp import epnp
    X, uv, K, R, t, bad = _pnp_scene(np.random.default_rng(seed), 1000, 0.5)
    (Rp, tp, inl_p), (Rc, tc, inl_c) = _both_pnp(X, uv, K)
    np.testing.assert_allclose(Rp, Rc, atol=1e-3, rtol=0)
    for tg in (tp, tc):
        np.testing.assert_allclose(tg, t, atol=5e-3, rtol=0)
    inl_p, inl_c = inl_p[:, 0], inl_c[:, 0]
    assert not np.intersect1d(inl_p, bad).size
    assert not np.intersect1d(inl_c, bad).size
    assert len(np.setxor1d(inl_p, inl_c)) <= 20
    R_own, t_own, _ = epnp(X[inl_p], uv[inl_p], K)
    np.testing.assert_allclose(np.c_[Rp, tp], np.c_[R_own, t_own],
                               atol=1e-12, rtol=0)
    R_own, t_own = _cv2_epnp(X[inl_c], uv[inl_c], K)
    np.testing.assert_allclose(np.c_[Rc, tc], np.c_[R_own, t_own],
                               atol=1e-6, rtol=0)
    common = np.intersect1d(inl_p, inl_c)
    Rp, tp, _ = epnp(X[common], uv[common], K)
    Rc, tc = _cv2_epnp(X[common], uv[common], K)
    np.testing.assert_allclose(Rp, Rc, atol=1e-3, rtol=0)
    np.testing.assert_allclose(tp, tc, atol=5e-3, rtol=0)


def test_pnp_noisy_matches_cv2():
    _noisy_ransac_check(5)


@pytest.mark.parametrize("seed", (6, 7))
def test_pnp_noisy_matches_cv2_other_scenes(seed):
    _noisy_ransac_check(seed)


def test_pnp_pose_refuses_few_map_hits():
    """Under 6 map hits both pipelines' _pnp_pose return None."""
    pytest.importorskip("cv2")
    from casmtr_tpu.sfm import pipeline as JP
    from casmtr_tpu_torch.sfm import pipeline as TP
    K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    mk0 = np.array([[10.0 * i, 20.0] for i in range(10)])
    depth = {(int(mk0[i][0] // 4), 5): 5.0 for i in range(5)}
    for mod in (JP, TP):
        assert mod._pnp_pose(mk0, mk0 + 1, depth, K, 4.0, 0.5) is None


# -------------------------------------------------------- comm and device

def test_comm_single_process():
    from casmtr_tpu_torch.parallel import comm
    from casmtr_tpu_torch.utils.metrics import gather_metrics
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.is_main_process()
    x = np.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(comm.all_gather_arrays(x), x[None])
    obj = {"a": [1, 2]}
    assert comm.all_gather(obj) == [obj] and comm.gather(obj) == [obj]
    assert comm.gather(obj, dst=1) == []
    assert comm.reduce_dict({"b": 2.0, "a": 1.0}) == {"a": 1.0, "b": 2.0}
    m = {"identifiers": ["x"], "R_errs": [1.0]}
    assert gather_metrics(m) is m


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available")
def test_device_work_needs_the_card():
    p = to_torch(make_problem(np.random.default_rng(0)), TB.BAProblem)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.run_ba(TB.to_device(p, "cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.build_problem(np.stack([np.eye(3)] * 2), np.zeros((2, 3)),
                         np.eye(3), {0: [(0, np.zeros(2)), (1, np.ones(2))]})
    from casmtr_tpu_torch.sfm import pipeline as TP
    from tests.test_sfm_pipeline import synth_sequence
    match_fn, K, _ = synth_sequence(np.random.default_rng(0), n_frames=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.reconstruct_sequence(match_fn, 3, K)
    with pytest.raises(NotImplementedError, match="device"):
        TP.reconstruct_sequence(match_fn, 3, K, pose_solver="cv2",
                                device="cpu")
