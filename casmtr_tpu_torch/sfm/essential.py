"""Essential-matrix RANSAC and pose recovery on the host: the port's
counterpart of OpenCV's ``findEssentialMat(..., method=RANSAC)`` and
``recoverPose``, which the JAX package's reference pose protocol calls
(``utils/metrics.estimate_pose``); the port does not use OpenCV.

float64 numpy throughout, as OpenCV's.

``five_point(x0, x1)`` solves S minimal samples of 5 normalised matches at
once (Stewenius, Engels and Nister, "Recent developments on direct
relative orientation", ISPRS 2006): the 4-dimensional null space of each
5 x 9 epipolar system by SVD, E = x E0 + y E1 + z E2 + E3; the ten cubic
constraints det E = 0 and 2 E E^T E - tr(E E^T) E = 0 over the 20
monomials of degree <= 3 in (x, y, z); Gauss-Jordan elimination of the
ten cubic monomials; the 10 x 10 action matrix of x on the quotient basis
(x^2, xy, xz, y^2, yz, z^2, x, y, z, 1), and a batched ``np.linalg.eig``
whose real eigenvalues are the solutions.  Each E is scaled to unit
Frobenius norm, with OpenCV's sign (the E3 coefficient is +1 before the
scaling).  OpenCV roots Nister's degree-10 polynomial instead: the same
solution set up to rounding, in another order, and the sign of each E
follows the SVD's choice of null-space signs.

``find_essential`` is OpenCV's ``RANSACPointSetRegistrator::run`` for
the five-point callback, with its draws: ``cv::RNG`` seeded with all ones
(the multiply-with-carry step ``state = (uint32)state * 4164903690 +
(state >> 32)``), each index ``next() % n``, an index already in the
sample drawn again in its place.  The error is the squared Sampson
distance of ``EMEstimatorCallback::computeError``, compared as OpenCV's
``findInliers`` does after storing it as float32 with float32(threshold^2)
(``inlier_bound``); a model replaces the best one when it has more
inliers (and at least 5); after each better model the number of
iterations shrinks by OpenCV's ``RANSACUpdateNumIters``
(``pnp._update_iters``), capped at OpenCV's default 1000 (the JAX protocol
passes no cap).  Exactly 5 matches give every solution of the sample and
a mask of ones, fewer give None, and nothing is refitted at the end.
Hypotheses are solved and scored in chunks of CHUNK doubling to
CHUNK_MAX, each cut at the iteration bound as it stood before it; the
best model and the stop are then found in OpenCV's sequential order, so
a chunk's hypotheses past the stop (fewer than the chunk) are scored but
never chosen.

``recover_pose`` is ``decomposeEssentialMat`` plus ``recoverPose``:
E = U diag V^T with the sign of U or V^T flipped where its determinant is
negative, R1 = U W V^T, R2 = U W^T V^T, t = U[:, 2]; each match
triangulated by DLT under the four (R, +-t) (P0 = [I | 0]): the least
singular vector of its 4 x 4 system, which OpenCV takes from an SVD, here
by a few power steps on the adjugate of the normal matrix for all points
at once, with an error bound; the few masked points whose tests lie
within that bound of flipping are solved again by the SVD, so every test
comes out as the SVD's.  A point counts where its homogeneous z and w
agree in sign, its depth in both cameras lies in (0, ``distance``) and
its mask bit is set; the first of (R1, t), (R2, t), (R1, -t), (R2, -t)
with the most points wins, and its points are the new mask.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from casmtr_tpu_torch.sfm.pnp import _update_iters

MODEL_POINTS = 5
MAX_ITERS = 1000
CHUNK = 8                   # hypotheses of the first chunk (doubles up to
CHUNK_MAX = 512             # this)
ERR_BLOCK = 1 << 15         # model x match errors held at once (in cache)
TRI_ITERS = 3               # power steps per triangulated point

_MWC_A = 4164903690
_U32 = 0xFFFFFFFF
_U64 = 0xFFFFFFFFFFFFFFFF

# variables (x, y, z, 1) -> the 20 monomials of degree <= 3 in x, y, z:
# the ten cubic ones to eliminate, then the quotient basis
_CUBIC = ((0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 1), (0, 1, 2), (0, 2, 2),
          (1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2))
_BASIS = ((0, 0, 3), (0, 1, 3), (0, 2, 3), (1, 1, 3), (1, 2, 3), (2, 2, 3),
          (0, 3, 3), (1, 3, 3), (2, 3, 3), (3, 3, 3))


def _monomial_map() -> np.ndarray:
    """[64, 20] 0/1: the product v_a v_b v_c (v = (x, y, z, 1)) of flat
    index 16 a + 4 b + c -> its monomial."""
    index = {m: i for i, m in enumerate(_CUBIC + _BASIS)}
    out = np.zeros((64, 20))
    for a in range(4):
        for b in range(4):
            for c in range(4):
                out[16 * a + 4 * b + c, index[tuple(sorted((a, b, c)))]] = 1
    return out


_MONO = _monomial_map()
_LEVI = np.zeros((3, 3, 3))
for _i, _j, _k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
    _LEVI[_i, _j, _k], _LEVI[_i, _k, _j] = 1.0, -1.0
# action of x on the basis: x * basis = _ACT_CUBIC rows of the reduced
# cubic monomials, then x^2, xy, xz, x (basis rows 0, 1, 2, 6)
_ACT_CUBIC = (0, 1, 2, 3, 4, 5)
_ACT_SHIFT = ((6, 0), (7, 1), (8, 2), (9, 6))


def _homogeneous(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.ones(x.shape[:-1] + (1,))], -1)


def _reduce(M: np.ndarray):
    """G with C G = B for each [10, 20] system M = [C | B]; NaN where C is
    singular (a degenerate sample)."""
    C, B = M[:, :, :10], M[:, :, 10:]
    try:
        return np.linalg.solve(C, B)
    except np.linalg.LinAlgError:
        G = np.full(B.shape, np.nan)
        for s in range(len(M)):
            try:
                G[s] = np.linalg.solve(C[s], B[s])
            except np.linalg.LinAlgError:
                pass
        return G


def five_point(x0: np.ndarray, x1: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The essential matrices of S minimal samples: x0, x1 [S, 5, 2]
    normalised matches (x1^T E x0 = 0) -> (E [S, 10, 3, 3] of unit
    Frobenius norm, valid [S, 10] bool), the real solutions first in each
    sample, in the eigen solver's order."""
    x0 = np.asarray(x0, np.float64)
    x1 = np.asarray(x1, np.float64)
    S = x0.shape[0]
    h0, h1 = _homogeneous(x0), _homogeneous(x1)
    Q = (h1[:, :, :, None] * h0[:, :, None, :]).reshape(S, 5, 9)
    Vt = np.linalg.svd(Q, full_matrices=True)[2]
    basis = Vt[:, 5:9].reshape(S, 4, 3, 3)
    Eb = basis.transpose(0, 2, 3, 1)                     # [S, 3, 3, 4]
    det = np.einsum("ijk,sia,sjb,skc->sabc", _LEVI, Eb[:, 0], Eb[:, 1],
                    Eb[:, 2], optimize=True)
    EEt = np.einsum("sika,sjkb->sijab", Eb, Eb, optimize=True)
    tr = np.einsum("siiab->sab", EEt)
    trace = (2.0 * np.einsum("sikab,skjc->sijabc", EEt, Eb, optimize=True)
             - np.einsum("sab,sijc->sijabc", tr, Eb, optimize=True))
    eqs = np.concatenate([det.reshape(S, 1, 64), trace.reshape(S, 9, 64)], 1)
    G = _reduce(eqs @ _MONO)                             # [S, 10, 10]
    act = np.zeros((S, 10, 10))
    act[:, :6] = -G[:, _ACT_CUBIC]
    for row, col in _ACT_SHIFT:
        act[:, row, col] = 1.0
    ok = np.all(np.isfinite(act), axis=(1, 2))
    act[~ok] = 0.0
    lam, vec = np.linalg.eig(act)                        # [S, 10], [S, 10, 10]
    real = (np.abs(lam.imag) <= 1e-10) & ok[:, None]
    vec = vec.real
    w = vec[:, 9]                                         # the monomial 1
    with np.errstate(divide="ignore", invalid="ignore"):
        xyz = np.stack([lam.real, vec[:, 7] / w, vec[:, 8] / w], -1)
        E = (np.einsum("skv,svij->skij", xyz, basis[:, :3])
             + basis[:, 3:4])                             # [S, 10, 3, 3]
        E = E / np.linalg.norm(E, axis=(2, 3), keepdims=True)
    real &= np.all(np.isfinite(E), axis=(2, 3))
    # real solutions first, each sample in the solver's order
    order = np.argsort(~real, axis=1, kind="stable")
    E = np.take_along_axis(E, order[:, :, None, None], 1)
    real = np.take_along_axis(real, order, 1)
    return np.where(real[:, :, None, None], E, 0.0), real


def _sampson_terms(x0: np.ndarray, x1: np.ndarray):
    """What the Sampson errors of matches x0, x1 [n, 2] take from them:
    (x1 (x) x0 [9, n], x0 homogeneous [3, n], x1 homogeneous [3, n])."""
    h0, h1 = _homogeneous(x0), _homogeneous(x1)
    q = (h1[:, :, None] * h0[:, None, :]).reshape(-1, 9)
    return (np.ascontiguousarray(q.T), np.ascontiguousarray(h0.T),
            np.ascontiguousarray(h1.T))


def _sampson(E: np.ndarray, terms) -> np.ndarray:
    """sampson_errors [M, n] of models E [M, 3, 3] on ``_sampson_terms``."""
    q, h0, h1 = terms
    num = E.reshape(len(E), 9) @ q                       # x1^T E x0
    den = E[:, 0] @ h0                                   # (E x0)_0
    den *= den
    for part in (E[:, 1] @ h0, E[:, :, 0] @ h1, E[:, :, 1] @ h1):
        part *= part
        den += part
    num *= num
    with np.errstate(divide="ignore", invalid="ignore"):
        num /= den
    return num


def sampson_errors(E: np.ndarray, x0: np.ndarray, x1: np.ndarray
                   ) -> np.ndarray:
    """OpenCV's EMEstimatorCallback::computeError before its float32
    store: the squared Sampson distance (x1^T E x0)^2 / ((E x0)_0^2 +
    (E x0)_1^2 + (E^T x1)_0^2 + (E^T x1)_1^2) of each match x0, x1 [n, 2]
    under each E [M, 3, 3], [n, M] float64."""
    return _sampson(np.asarray(E, np.float64), _sampson_terms(
        np.asarray(x0, np.float64), np.asarray(x1, np.float64))).T


def inlier_bound(threshold: float) -> float:
    """The largest float64 e with float32(e) <= float32(threshold^2), so
    that ``e <= inlier_bound(t)`` is OpenCV's findInliers test (the error
    stored as float32, compared with float32(t^2)) without the store:
    below the midpoint to the next float32, or at it when float32(t^2)
    is even, as round-to-nearest-even breaks the tie."""
    t32 = np.float32(float(threshold) ** 2)
    mid = (float(t32) + float(np.nextafter(t32, np.float32(np.inf)))) / 2
    return mid if int(t32.view(np.uint32)) % 2 == 0 else float(
        np.nextafter(mid, -np.inf))


@functools.lru_cache(maxsize=64)
def cv_samples(n: int, k: int) -> np.ndarray:
    """The first ``k`` samples [k, 5] of indices in [0, n) that OpenCV's
    RANSAC draws (getSubset): each index ``next() % n`` of
    ``cv::RNG((uint64)-1)``, an index already in the sample drawn
    again."""
    if n < MODEL_POINTS:
        raise ValueError(f"{n} points: a sample needs {MODEL_POINTS}")
    out, state = [], _U64
    for _ in range(k):
        idx = []
        while len(idx) < MODEL_POINTS:
            state = ((state & _U32) * _MWC_A + (state >> 32)) & _U64
            v = (state & _U32) % n
            if v not in idx:
                idx.append(v)
        out.append(idx)
    return np.array(out, np.int64)


def find_essential(x0: np.ndarray, x1: np.ndarray, threshold: float,
                   prob: float = 0.999
                   ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """RANSAC over the five-point solver, as ``cv2.findEssentialMat(x0, x1,
    np.eye(3), method=cv2.RANSAC, prob=prob, threshold=threshold)`` (at
    most MAX_ITERS iterations): x0, x1 [n, 2] normalised matches.  Returns
    (E [k, 3, 3], inlier mask [n] bool): one E, or every solution of the
    sample when n == 5; (None, zeros) when no model was found."""
    x0 = np.asarray(x0, np.float64).reshape(-1, 2)
    x1 = np.asarray(x1, np.float64).reshape(-1, 2)
    n = len(x0)
    none = (None, np.zeros(n, bool))
    if n < MODEL_POINTS:
        return none
    if n == MODEL_POINTS:
        E, ok = five_point(x0[None], x1[None])
        if not ok[0].any():
            return none
        return E[0][ok[0]], np.ones(n, bool)
    bound = inlier_bound(threshold)
    terms = _sampson_terms(x0, x1)
    niters = MAX_ITERS
    samples = cv_samples(n, niters)
    best_E, best_count = None, 0
    it, chunk = 0, CHUNK
    while it < niters:
        stop = min(niters, it + chunk)
        idx = samples[it:stop]
        E, ok = five_point(x0[idx], x1[idx])
        which, sol = np.nonzero(ok)                      # sequential order
        models = E[which, sol]
        rows = max(1, ERR_BLOCK // n)
        counts = np.concatenate(
            [np.count_nonzero(_sampson(models[i:i + rows], terms) <= bound,
                              axis=1)
             for i in range(0, len(models), rows)] or [np.zeros(0, int)])
        # the models that beat every earlier one, in OpenCV's order
        prior = np.maximum.accumulate(
            np.concatenate([[max(best_count, MODEL_POINTS - 1)], counts]))
        better = np.flatnonzero(counts > prior[:-1])
        start_iters, last = niters, -1
        for m in better:
            i = it + int(which[m])
            if i != last:                    # OpenCV tests the bound at
                start_iters, last = niters, i    # the start of an iteration
            if i >= start_iters:
                break
            best_E, best_count = models[m], int(counts[m])
            niters = _update_iters(prob, (n - best_count) / n, MODEL_POINTS,
                                   niters)
        it, chunk = stop, min(2 * chunk, CHUNK_MAX)
    if best_E is None:
        return none
    return best_E[None], _sampson(best_E[None], terms)[0] <= bound


def decompose_essential(E: np.ndarray):
    """OpenCV's decomposeEssentialMat: (R1, R2, t [3])."""
    U, _, Vt = np.linalg.svd(np.asarray(E, np.float64).reshape(3, 3))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2].copy()


def _adjugate(a):
    """adj(a) (adj(a) a = det(a) I) of 4 x 4 matrices given entry by entry
    (``a[i][j]`` an array over the matrices), from the 2 x 2 minors of the
    top and bottom row pairs; the same layout out."""
    (a00, a01, a02, a03), (a10, a11, a12, a13), (a20, a21, a22, a23), \
        (a30, a31, a32, a33) = a
    s0, s1, s2 = a00 * a11 - a10 * a01, a00 * a12 - a10 * a02, \
        a00 * a13 - a10 * a03
    s3, s4, s5 = a01 * a12 - a11 * a02, a01 * a13 - a11 * a03, \
        a02 * a13 - a12 * a03
    c0, c1, c2 = a20 * a31 - a30 * a21, a20 * a32 - a30 * a22, \
        a20 * a33 - a30 * a23
    c3, c4, c5 = a21 * a32 - a31 * a22, a21 * a33 - a31 * a23, \
        a22 * a33 - a32 * a23
    return ((a11 * c5 - a12 * c4 + a13 * c3, -a01 * c5 + a02 * c4 - a03 * c3,
             a31 * s5 - a32 * s4 + a33 * s3, -a21 * s5 + a22 * s4 - a23 * s3),
            (-a10 * c5 + a12 * c2 - a13 * c1, a00 * c5 - a02 * c2 + a03 * c1,
             -a30 * s5 + a32 * s2 - a33 * s1, a20 * s5 - a22 * s2 + a23 * s1),
            (a10 * c4 - a11 * c2 + a13 * c0, -a00 * c4 + a01 * c2 - a03 * c0,
             a30 * s4 - a31 * s2 + a33 * s0, -a20 * s4 + a21 * s2 - a23 * s0),
            (-a10 * c3 + a11 * c1 - a12 * c0, a00 * c3 - a01 * c1 + a02 * c0,
             -a30 * s3 + a31 * s1 - a32 * s0, a20 * s3 - a21 * s1 + a22 * s0))


def _null_vectors(A: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The least right singular vector v [..., 4] (unit, up to sign) of
    each DLT system A [..., 4, 4], and a bound on the sine of its angle to
    the exact one, entry by entry over all systems at once.  v: TRI_ITERS
    products with adj(M), M = A^T A, from adj(M)'s largest column;
    adj(M) = sum_i (prod_{j != i} l_j) v_i v_i^T, whose leading term is
    the least eigenvalue l_1's.  The bound is Davis and Kahan's residual
    over the gap, |M v - mu v| / (l_2 - mu), mu = v^T M v >= l_1, with
    l_2 bounded below by (tr adj(M) - mu e_2(M)) / (tr M / 2)^2 (as
    l_2 l_3 l_4 >= e_3 - l_1 e_2 and l_3 l_4 <= (tr M / 2)^2), each term
    widened by its rounding; infinite where that gap is not positive."""
    a = [[np.ascontiguousarray(A[..., k, i]) for i in range(4)]
         for k in range(4)]
    m = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            m[i][j] = m[j][i] = sum(a[k][i] * a[k][j] for k in range(4))
    b = _adjugate(m)
    col = np.argmax(np.stack([sum(b[i][j] ** 2 for i in range(4))
                              for j in range(4)]), 0)
    v = [np.choose(col, b[i]) for i in range(4)]
    eps = np.finfo(np.float64).eps
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(TRI_ITERS):
            norm = np.sqrt(sum(x * x for x in v))
            v = [sum(b[i][j] * v[j] / norm for j in range(4))
                 for i in range(4)]
        norm = np.sqrt(sum(x * x for x in v))
        v = [x / norm for x in v]
        mv = [sum(m[i][j] * v[j] for j in range(4)) for i in range(4)]
        mu = sum(x * y for x, y in zip(v, mv))
        resid = np.sqrt(sum((x - mu * y) ** 2 for x, y in zip(mv, v)))
        size = np.sqrt(sum(m[i][j] ** 2 for i in range(4) for j in range(4)))
        tr = sum(m[i][i] for i in range(4))
        e2 = (tr * tr - size * size) / 2
        e3 = sum(b[i][i] for i in range(4))
        l2 = (e3 - mu * e2 - 64 * eps * size ** 3) / (tr / 2) ** 2
        gap = l2 - mu - 32 * eps * size
        bound = (resid + 32 * eps * size) / gap
    bound = np.where((gap > 0) & np.isfinite(bound), bound, np.inf)
    return np.stack(v, -1), bound


def recover_pose(E: np.ndarray, x0: np.ndarray, x1: np.ndarray,
                 mask: Optional[np.ndarray] = None, distance: float = 50.0
                 ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """``cv2.recoverPose(E, x0, x1, np.eye(3), distanceThresh=distance,
    mask=mask)`` on normalised matches x0, x1 [n, 2] (``distance`` 50 is
    OpenCV's default, that of the overload without it): (good points,
    R [3, 3], t [3], the winning pose's mask [n] bool).  Each point's
    DLT system is solved by ``_null_vectors``; a masked point whose tests
    lie within that solution's error bound of flipping is solved again
    by the SVD, as OpenCV's triangulatePoints does for every point."""
    x0 = np.asarray(x0, np.float64).reshape(-1, 2)
    x1 = np.asarray(x1, np.float64).reshape(-1, 2)
    n = len(x0)
    R1, R2, t = decompose_essential(E)
    poses = ((R1, t), (R2, t), (R1, -t), (R2, -t))
    P = np.stack([np.concatenate([R, tt[:, None]], 1) for R, tt in poses])
    P0 = np.eye(3, 4)
    # DLT rows x P[2] - P[0], y P[2] - P[1] of both views: [4, n, 4, 4]
    A = np.empty((4, n, 4, 4))
    A[:, :, 0] = x0[:, 0, None] * P0[2] - P0[0]
    A[:, :, 1] = x0[:, 1, None] * P0[2] - P0[1]
    A[:, :, 2] = (x1[None, :, 0, None] * P[:, None, 2]
                  - P[:, None, 0])
    A[:, :, 3] = (x1[None, :, 1, None] * P[:, None, 2]
                  - P[:, None, 1])
    X, bound = _null_vectors(A)                           # [4, n, 4], [4, n]
    keep = (np.ones((1, n), bool) if mask is None
            else np.asarray(mask).reshape(1, n).astype(bool))
    # the tests as linear forms in X (z w > 0, z / w < d, 0 < depth1 < d):
    # each flips only where its form is within bound x its row's norm of 0
    d = float(distance)
    g = np.einsum("pj,pnj->pn", P[:, 2], X)               # depth1 x w
    tz = np.abs(P[:, 2, 3, None])
    with np.errstate(invalid="ignore"):
        sure = ((np.abs(X[..., 2]) > 2 * bound)
                & (np.abs(X[..., 3]) > 2 * bound)
                & (np.abs(X[..., 2] - d * X[..., 3]) > 2 * bound * (1 + d))
                & (np.abs(g) > 2 * bound * (1 + tz))
                & (np.abs(g - d * X[..., 3]) > 2 * bound * (1 + tz + d)))
    redo = keep & ~sure
    if redo.any():
        X[redo] = np.linalg.svd(A[redo])[2][..., 3, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        good = X[..., 2] * X[..., 3] > 0
        Xn = X[..., :3] / X[..., 3:]
        depth1 = np.einsum("pj,pnj->pn", P[:, 2, :3], Xn) + P[:, 2, 3, None]
        good &= (Xn[..., 2] < distance) & (depth1 > 0) & (depth1 < distance)
    good &= keep
    counts = good.sum(1)
    k = next(i for i in range(4) if counts[i] >= counts.max())
    R, tt = poses[k]
    return int(counts[k]), R, tt.copy(), good[k]
