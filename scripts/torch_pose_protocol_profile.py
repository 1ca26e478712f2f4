"""Where the reference pose protocol's host time goes, per pair.

Runs ``casmtr_tpu_torch.utils.metrics.estimate_pose`` (sfm/essential.py:
OpenCV's RANSAC draws, the five-point solver, recoverPose) on the scenes
of chip_smoke.py's phase 17(a) (the same generator and seed: numpy copies
of tests/test_pose_solver._scene, 0.3 px, 8 scenes per N and outlier
share) and splits each call's time into the sample draws, the five-point
solves, the Sampson scoring, the rest of find_essential, and recover_pose.
With ``--cv2`` (where OpenCV is installed; the port itself never imports
it) the same scenes also go through ``cv2.findEssentialMat`` and
``cv2.recoverPose`` as the JAX package calls them, timed on the same
host, and both poses' errors against the truth are printed.

    python scripts/torch_pose_protocol_profile.py [--ns 2048 8192] [--cv2]

Prints one line per (N, outlier share) with the medians over the scenes,
in ms per pair on this host's CPU.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from casmtr_tpu_torch.sfm import essential  # noqa: E402
from casmtr_tpu_torch.utils import metrics  # noqa: E402

NS = (512, 2048, 8192)
SHARES = (0.0, 0.3)
SCENES = 8
THRESH_PX = 0.5


def rodrigues(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def rot_deg(Ra, Rb):
    return np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(
        np.asarray(Ra, np.float64) - Rb) / (2 * 2 ** 0.5))))


def dir_deg(a, b):
    a = np.asarray(a, np.float64).ravel() / np.linalg.norm(a)
    b = np.asarray(b, np.float64).ravel() / np.linalg.norm(b)
    return np.degrees(2 * np.arcsin(min(1.0, np.linalg.norm(a - b) / 2)))


def scene(rng, R, t, n, n_out, noise=0.3, f=400.0, c=320.0):
    """chip_smoke.protocol_scene."""
    K = np.array([[f, 0, c], [0, f, c], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 10, n)], axis=1)
    x0 = X / X[:, 2:3]
    X1 = X @ R.T + t
    x1 = X1 / X1[:, 2:3]
    k0 = (x0 @ K.T)[:, :2] + rng.normal(0, noise, (n, 2))
    k1 = (x1 @ K.T)[:, :2] + rng.normal(0, noise, (n, 2))
    k0_out = rng.uniform(0, 2 * c, (n_out, 2))
    k1_out = rng.uniform(0, 2 * c, (n_out, 2))
    return (np.concatenate([k0, k0_out]).astype(np.float32),
            np.concatenate([k1, k1_out]).astype(np.float32),
            K.astype(np.float32))


def scenes():
    """{(N, share): [(R, t, kpts0, kpts1, K)]} in phase 17(a)'s order."""
    rng = np.random.default_rng(17)
    out = {}
    for N in NS:
        for share in SHARES:
            n_out = int(round(N * share))
            rows = []
            for _ in range(SCENES):
                R = rodrigues(rng.standard_normal(3), rng.uniform(0.1, 0.3))
                t = rng.standard_normal(3)
                t /= np.linalg.norm(t)
                rows.append((R, t) + scene(rng, R, t, N - n_out, n_out))
            out[N, share] = rows
    return out


class Clock:
    """Wraps module functions to sum their wall time by name."""

    def __init__(self):
        self.ms = {}

    def wrap(self, module, name):
        fn = getattr(module, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[name] = (self.ms.get(name, 0.0)
                                 + (time.perf_counter() - t0) * 1e3)
        setattr(module, name, timed)


def cv2_pose(cv2, k0, k1, K):
    """The JAX package's estimate_pose with OpenCV, timed."""
    kp0 = (k0 - K[[0, 1], [2, 2]][None]) / K[[0, 1], [0, 1]][None]
    kp1 = (k1 - K[[0, 1], [2, 2]][None]) / K[[0, 1], [0, 1]][None]
    thr = THRESH_PX / np.mean([K[0, 0], K[1, 1], K[0, 0], K[1, 1]])
    t0 = time.perf_counter()
    E, mask = cv2.findEssentialMat(kp0, kp1, np.eye(3), threshold=thr,
                                   prob=0.99999, method=cv2.RANSAC)
    t1 = time.perf_counter()
    best, ret = 0, None
    for _E in np.split(E, len(E) / 3):
        n, R, t, _ = cv2.recoverPose(_E, kp0, kp1, np.eye(3), 1e9, mask=mask)
        if n > best:
            best, ret = n, (R, t[:, 0], mask.ravel() > 0)
    t2 = time.perf_counter()
    return ret, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ns", type=int, nargs="*", default=list(NS))
    p.add_argument("--cv2", action="store_true",
                   help="also time OpenCV on the same scenes")
    args = p.parse_args(argv)
    cv2 = None
    if args.cv2:
        import cv2
        cv2.setNumThreads(1)
    clock = Clock()
    draws = essential.cv_samples       # cleared before each pair: cold
    for name in ("cv_samples", "five_point", "_sampson"):
        clock.wrap(essential, name)
    for name in ("find_essential", "recover_pose"):
        clock.wrap(metrics, name)
    for (N, share), rows in scenes().items():
        if N not in args.ns:
            continue
        parts = {k: [] for k in ("total", "find_essential", "cv_samples",
                                 "five_point", "_sampson",
                                 "recover_pose", "cv2_find", "cv2_recover")}
        errs, cv_errs = [], []
        for R, t, k0, k1, K in rows:
            draws.cache_clear()
            clock.ms.clear()
            t0 = time.perf_counter()
            Rh, th, _ = metrics.estimate_pose(k0, k1, K, K, THRESH_PX)
            parts["total"].append((time.perf_counter() - t0) * 1e3)
            for k in ("find_essential", "cv_samples", "five_point",
                      "_sampson", "recover_pose"):
                parts[k].append(clock.ms.get(k, 0.0))
            errs.append((rot_deg(Rh, R), dir_deg(th, t)))
            if cv2 is not None:
                ret, tf, tr = cv2_pose(cv2, k0, k1, K)
                parts["cv2_find"].append(tf)
                parts["cv2_recover"].append(tr)
                cv_errs.append((rot_deg(ret[0], R), dir_deg(ret[1], t)))
        med = {k: statistics.median(v) for k, v in parts.items() if v}
        rest = med["find_essential"] - (med["cv_samples"] + med["five_point"]
                                        + med["_sampson"])
        line = (f"N {N}, {share:.0%} outliers: port {med['total']:.2f} ms "
                f"per pair = find_essential {med['find_essential']:.2f} "
                f"(draws {med['cv_samples']:.2f}, five_point "
                f"{med['five_point']:.2f}, Sampson {med['_sampson']:.2f},"
                f" rest {rest:.2f}) + recover_pose "
                f"{med['recover_pose']:.2f}; largest R / t error "
                f"{max(e[0] for e in errs):.3f} / {max(e[1] for e in errs):.3f}"
                " deg")
        if cv2 is not None:
            line += (f"; OpenCV {med['cv2_find'] + med['cv2_recover']:.2f} ms"
                     f" = findEssentialMat {med['cv2_find']:.2f} + "
                     f"recoverPose {med['cv2_recover']:.2f}; largest R / t "
                     f"error {max(e[0] for e in cv_errs):.3f} / "
                     f"{max(e[1] for e in cv_errs):.3f} deg")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
