"""The port's reference pose protocol (``sfm/essential.py`` and
``utils/metrics.estimate_pose``) against OpenCV and the JAX package, on
the CPU (OpenCV is a witness here only; the port does not import it):

* ``five_point`` on exact five-point samples: the true E among the
  solutions within 1e-8 (up to sign, both of unit norm); every solution
  meets det E = 0, 2 E E^T E - tr(E E^T) E = 0 and the five epipolar
  constraints within 1e-9; the solution set equal to what
  ``cv2.findEssentialMat`` returns on those five points within 1e-6 (up
  to sign; the order differs, see below);
* ``pnp._update_iters`` (OpenCV's RANSACUpdateNumIters) against the
  formula, at outlier ratios 0 and 1 too;
* ``cv_samples`` against a plain sequential ``cv::RNG`` (multiply with
  carry, ``next() % n``, a repeated index drawn again), at n = 6 (many
  redraws) to 4096;
* ``recover_pose`` against ``cv2.recoverPose`` on points behind either
  camera and beyond depth 50, with ``distanceThresh=1e9`` and with the
  call the JAX function makes, ``recoverPose(E, x0, x1, eye, 1e9,
  mask=m)``, whose 1e9 lands in the R output of the overload without a
  distance (OpenCV's default 50 applies): n equal, R and t within 1e-9,
  the mask bit-equal (cv2 writes it into ``m``);
* ``recover_pose``'s triangulation (power steps with an error bound, the
  SVD where a test lies within it) against the SVD for every point, on
  hard cases (zero parallax, points near infinity, tiny baselines, 1e-2
  noise): n, R, t and the mask identical;
* ``inlier_bound`` against OpenCV's float32 store of the error, on the
  float64 values around the bound;
* ``find_essential`` against ``cv2.findEssentialMat(..., RANSAC)``: E
  within 1e-7 (up to sign) and the same inliers, as the draws are
  OpenCV's; and ``estimate_pose`` / ``compute_pose_errors`` against the
  JAX package's on test_pose_solver's scenes, N 4 to 4096, 0.3 and 1 px,
  0-50% outliers: None in both below 5 matches; else R and t within
  1e-7 and the inlier masks equal but for rows whose Sampson error lies
  within 1% of the threshold (none has so far);
* at N = 5 the solutions come in another order than OpenCV's (it roots
  Nister's polynomial), and since each ``recoverPose`` starts from the
  previous one's mask, the first E with a point in front wins: the
  port's loop fed OpenCV's stack of E's gives the JAX function's pose
  and mask exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from casmtr_tpu.utils import metrics as JM  # noqa: E402
from casmtr_tpu_torch.sfm import essential as es  # noqa: E402
from casmtr_tpu_torch.sfm.pnp import _update_iters  # noqa: E402
from casmtr_tpu_torch.utils import metrics as TM  # noqa: E402
from tests.test_pose_solver import _rotmat, _scene  # noqa: E402

TRUE_E_ATOL = 1e-8
CONSTRAINT_ATOL = 1e-9
CV_SET_ATOL = 1e-6
RECOVER_ATOL = 1e-9
E_ATOL = 1e-7
POSE_ATOL = 1e-7
INLIER_MARGIN = 0.01


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def _five(rng):
    R = _rotmat(rng.normal(size=3), rng.uniform(0.05, 0.4))
    t = rng.normal(size=3)
    X = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-2, 2, 5),
                  rng.uniform(4, 10, 5)], 1)
    X1 = X @ R.T + t
    E = _skew(t) @ R
    return X[:, :2] / X[:, 2:], X1[:, :2] / X1[:, 2:], E / np.linalg.norm(E)


def _sign_dist(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


@pytest.mark.parametrize("seed", range(6))
def test_five_point_exact(seed):
    x0, x1, E_true = _five(np.random.default_rng(seed))
    E, ok = es.five_point(x0[None], x1[None])
    sols = E[0][ok[0]]
    assert 1 <= len(sols) <= 10 and not ok[0][len(sols):].any()
    assert min(_sign_dist(e, E_true) for e in sols) <= TRUE_E_ATOL
    h0 = np.c_[x0, np.ones(5)]
    h1 = np.c_[x1, np.ones(5)]
    for e in sols:
        assert np.linalg.norm(e) == pytest.approx(1.0, abs=1e-12)
        assert abs(np.linalg.det(e)) <= CONSTRAINT_ATOL
        trace = 2 * e @ e.T @ e - np.trace(e @ e.T) * e
        assert np.abs(trace).max() <= CONSTRAINT_ATOL
        assert np.abs(np.sum(h1 * (h0 @ e.T), 1)).max() <= CONSTRAINT_ATOL
    Ec, _ = cv2.findEssentialMat(x0, x1, np.eye(3), method=cv2.RANSAC,
                                 threshold=1e-3)
    Ec = Ec.reshape(-1, 3, 3)
    assert len(Ec) == len(sols)
    for e in sols:
        assert min(_sign_dist(e, c) for c in Ec) <= CV_SET_ATOL
    for c in Ec:
        assert min(_sign_dist(e, c) for e in sols) <= CV_SET_ATOL


def test_five_point_degenerate_sample_is_invalid():
    x = np.zeros((2, 5, 2))
    x[1] = np.random.default_rng(0).uniform(-1, 1, (5, 2))
    E, ok = es.five_point(x, x)
    assert not ok[0].any()
    assert np.isfinite(E).all()


def _cv_round(v):
    return int(np.rint(v))


@pytest.mark.parametrize("p, ep, want", [
    (0.99999, 0.0, 0), (0.99999, 1.0, 1000), (0.999, 1.0, 1000),
    (0.99999, 0.3, _cv_round(np.log(1e-5) / np.log(1 - 0.7 ** 5))),
    (0.99999, 0.5, _cv_round(np.log(1e-5) / np.log(1 - 0.5 ** 5))),
    (0.999, 0.9, 1000), (1.0, 0.5, 1000),
    (0.99, 0.2, _cv_round(np.log(0.01) / np.log(1 - 0.8 ** 5)))])
def test_update_iters_formula(p, ep, want):
    got = _update_iters(p, ep, 5, 1000)
    assert got == want
    # the count never grows
    assert _update_iters(p, ep, 5, 7) == min(want, 7) or want == 0


def _sequential_samples(n, k):
    """cv::RNG((uint64)-1) and getSubset, one draw at a time."""
    state, out = (1 << 64) - 1, []
    for _ in range(k):
        idx = []
        while len(idx) < 5:
            state = ((state & 0xFFFFFFFF) * 4164903690 + (state >> 32)) \
                & ((1 << 64) - 1)
            v = (state & 0xFFFFFFFF) % n
            if v not in idx:
                idx.append(v)
        out.append(idx)
    return np.array(out)


@pytest.mark.parametrize("n", (6, 7, 11, 50, 513, 4096))
def test_cv_samples_follow_opencv_rng(n):
    k = 300 if n < 20 else 1000
    np.testing.assert_array_equal(es.cv_samples(n, k),
                                  _sequential_samples(n, k))


@pytest.mark.parametrize("distance", (None, 1e9))
@pytest.mark.parametrize("seed", range(4))
def test_recover_pose_matches_cv2(seed, distance):
    rng = np.random.default_rng(seed)
    R = _rotmat(rng.normal(size=3), 0.3)
    t = rng.normal(size=3)
    n = 300
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(-3, 10, n)], 1)       # some behind camera 0
    X[::10] *= 8                                    # some beyond depth 50
    X1 = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    x1 = X1[:, :2] / X1[:, 2:]
    assert (X[:, 2] < 0).any() and (X1[:, 2] < 0).any()
    E = _skew(t) @ R
    mask = (rng.uniform(size=(n, 1)) > 0.2).astype(np.uint8)
    mc = mask.copy()
    if distance is None:
        out = cv2.recoverPose(E, x0, x1, np.eye(3), 1e9, mask=mc)
        assert len(out) == 4                # no distance in this overload
        got_n, Rp, tp, mp = es.recover_pose(E, x0, x1, mask)
    else:
        out = cv2.recoverPose(E, x0, x1, np.eye(3), distanceThresh=distance,
                              mask=mc)
        got_n, Rp, tp, mp = es.recover_pose(E, x0, x1, mask, distance)
    nc, Rc, tc = out[:3]
    assert got_n == nc
    np.testing.assert_allclose(Rp, Rc, atol=RECOVER_ATOL, rtol=0)
    np.testing.assert_allclose(tp, tc[:, 0], atol=RECOVER_ATOL, rtol=0)
    np.testing.assert_array_equal(mp, mc.ravel() > 0)
    assert mask.sum() > mp.sum()


def _recover_pose_svd(E, x0, x1, mask, distance):
    """recover_pose with every point triangulated by the SVD, as OpenCV's
    triangulatePoints."""
    R1, R2, t = es.decompose_essential(E)
    poses = ((R1, t), (R2, t), (R1, -t), (R2, -t))
    n = len(x0)
    best = None
    for R, tt in poses:
        P = np.concatenate([R, tt[:, None]], 1)
        A = np.stack([np.stack([-np.ones(n), np.zeros(n), x0[:, 0],
                                np.zeros(n)], -1),
                      np.stack([np.zeros(n), -np.ones(n), x0[:, 1],
                                np.zeros(n)], -1),
                      x1[:, :1] * P[2] - P[0], x1[:, 1:] * P[2] - P[1]], 1)
        X = np.linalg.svd(A)[2][:, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            good = X[:, 2] * X[:, 3] > 0
            Xn = X[:, :3] / X[:, 3:]
            d1 = Xn @ P[2, :3] + P[2, 3]
            good &= (Xn[:, 2] < distance) & (d1 > 0) & (d1 < distance)
        if mask is not None:
            good &= mask
        if best is None or good.sum() > best[0]:
            best = (int(good.sum()), R, tt, good)
    return best


@pytest.mark.parametrize("seed", range(12))
def test_recover_pose_triangulation_equals_svd(seed):
    rng = np.random.default_rng(seed)
    n = (5, 60, 400, 2000)[seed % 4]
    R = _rotmat(rng.normal(size=3), rng.uniform(0.0, 0.5))
    t = rng.normal(size=3) * (1.0, 1e-2, 1e-4)[seed % 3]
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(-3, 10, n)], 1)
    X[::7] *= rng.uniform(1, 20)
    X[::5] *= 1e6 if seed % 2 else 1.0                  # near infinity
    X1 = X @ R.T + t
    noise = (0.0, 1e-4, 1e-3, 1e-2)[seed % 4]
    x0 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    x1 = X1[:, :2] / X1[:, 2:] + rng.normal(0, noise, (n, 2))
    out = rng.uniform(size=n) < 0.2
    x1[out] = rng.uniform(-1, 1, (out.sum(), 2))
    if seed % 3 == 0:
        x1[::3] = x0[::3]                               # zero parallax
    E = _skew(t) @ R + rng.normal(0, 1e-3 * (seed % 2), (3, 3))
    mask = rng.uniform(size=n) > 0.1 if seed < 8 else None
    for distance in (50.0, 1e9):
        got = es.recover_pose(E, x0, x1, mask, distance)
        want = _recover_pose_svd(E, x0, x1, mask, distance)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("threshold", [0.5 / 400, 1.0 / 800, 1e-3, 0.7,
                                       3.0])
def test_inlier_bound_is_the_float32_store(threshold):
    bound = es.inlier_bound(threshold)
    t32 = np.float32(threshold * threshold)
    near = [bound]
    for _ in range(4):
        near += [np.nextafter(near[-1], np.inf)]
    x = bound
    for _ in range(4):
        x = np.nextafter(x, -np.inf)
        near.append(x)
    rng = np.random.default_rng(0)
    near = np.concatenate([np.array(near),
                           bound * (1 + rng.uniform(-1e-6, 1e-6, 2000))])
    np.testing.assert_array_equal(near <= bound,
                                  near.astype(np.float32) <= t32)
    assert np.float32(bound) <= t32 < np.float32(np.nextafter(bound, np.inf))


def _normalised(k, K):
    return (k - K[[0, 1], [2, 2]][None]) / K[[0, 1], [0, 1]][None]


CASES = [(n, noise, out, seed)
         for n in (50, 500) for noise in (0.3, 1.0)
         for out in (0.0, 0.3, 0.5) for seed in (0, 1)] + \
        [(4096, 0.3, 0.0, 0), (4096, 1.0, 0.3, 0), (4096, 0.3, 0.5, 0)]


def _pose_scene(n, noise, out, seed):
    rng = np.random.default_rng(seed)
    R = _rotmat(rng.normal(size=3), rng.uniform(0.05, 0.3))
    t = rng.normal(size=3)
    n_out = int(round(n * out))
    return _scene(rng, R, t, n=n - n_out, n_out=n_out, noise=noise)


@pytest.mark.parametrize("n, noise, out, seed", CASES)
def test_find_essential_and_estimate_pose_match(n, noise, out, seed):
    k0, k1, _, K = _pose_scene(n, noise, out, seed)
    thr = 0.5 / np.mean([K[0, 0], K[1, 1], K[0, 0], K[1, 1]])
    x0, x1 = _normalised(k0, K), _normalised(k1, K)
    Ec, mc = cv2.findEssentialMat(x0, x1, np.eye(3), threshold=thr,
                                  prob=0.99999, method=cv2.RANSAC)
    Ep, mp = es.find_essential(x0, x1, thr, 0.99999)
    assert Ec.shape == (3, 3) and Ep.shape == (1, 3, 3)
    assert _sign_dist(Ep[0], Ec) <= E_ATOL
    err = es.sampson_errors(Ec[None], x0, x1)[:, 0]
    near = np.abs(err / np.float32(thr * thr) - 1) <= INLIER_MARGIN
    assert ((mp != (mc.ravel() > 0)) <= near).all()

    want = JM.estimate_pose(k0, k1, K, K, 0.5)
    got = TM.estimate_pose(k0, k1, K, K, 0.5)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_allclose(got[0], want[0], atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(got[1], want[1], atol=POSE_ATOL, rtol=0)
        assert ((got[2] != want[2]) <= near).all()
    if n == 50 and seed == 0:
        Tm = np.eye(4)
        Tm[:3, :3] = _rotmat([0, 1, 0], 0.1)
        Tm[:3, 3] = [1.0, 0.0, 0.0]
        errs_w = JM.compute_pose_errors(k0, k1, Tm, K, K)
        errs_g = TM.compute_pose_errors(k0, k1, Tm, K, K)
        np.testing.assert_allclose(errs_g[:2], errs_w[:2], atol=1e-5)
        np.testing.assert_array_equal(errs_g[2], errs_w[2])


@pytest.mark.parametrize("n", (0, 3, 4))
def test_too_few_matches(n):
    k = np.zeros((n, 2), np.float32)
    K = np.eye(3, dtype=np.float32)
    assert JM.estimate_pose(k, k, K, K, 0.5) is None
    assert TM.estimate_pose(k, k, K, K, 0.5) is None
    E, mask = es.find_essential(k, k, 1e-3)
    assert E is None and mask.shape == (n,) and not mask.any()
    R_err, t_err, inl = TM.compute_pose_errors(k, k, np.eye(4), K, K)
    assert R_err == t_err == np.inf and inl.shape == (0,)


@pytest.mark.parametrize("seed", range(6))
def test_five_matches_thread_the_mask_as_cv2(seed, monkeypatch):
    """Five matches: every solution comes back (the same set as cv2's);
    with cv2's stack in cv2's order, the port's loop returns the JAX
    function's pose and mask exactly."""
    rng = np.random.default_rng(100 + seed)
    R = _rotmat(rng.normal(size=3), 0.2)
    k0, k1, _, K = _scene(rng, R, rng.normal(size=3), n=5, n_out=0)
    x0, x1 = _normalised(k0, K), _normalised(k1, K)
    thr = 0.5 / np.mean([K[0, 0], K[1, 1], K[0, 0], K[1, 1]])
    Ec, mc = cv2.findEssentialMat(x0, x1, np.eye(3), threshold=thr,
                                  prob=0.99999, method=cv2.RANSAC)
    Ec = Ec.reshape(-1, 3, 3)
    Ep, mp = es.find_essential(x0, x1, thr, 0.99999)
    assert len(Ep) == len(Ec) and mp.all() and (mc == 1).all()
    for e in Ep:
        assert min(_sign_dist(e, c) for c in Ec) <= CV_SET_ATOL
    want = JM.estimate_pose(k0, k1, K, K, 0.5)
    monkeypatch.setattr(TM, "find_essential",
                        lambda *a, **k: (Ec, np.ones(5, bool)))
    got = TM.estimate_pose(k0, k1, K, K, 0.5)
    np.testing.assert_allclose(got[0], want[0], atol=RECOVER_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=RECOVER_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])
