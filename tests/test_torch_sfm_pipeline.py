"""The port's SfM pipeline and reconstruct command against the JAX
package's, on the CPU, on tests/test_sfm_pipeline.py's synthetic
sequences (``pose_solver="device"`` in both, the port fed the JAX key's
draw through ``pipeline.estimate_pose_batch``, unless ``cv2`` is named):

* ``pair_graph``, ``select_keyframes`` with its cache, ``match_pairs``
  with an injected two-rank gather and ``build_tracks``: identical;
* ``_pair_poses_device`` on the JAX draw (the same [B, 512, M] batching;
  in chunks of two pairs the same inliers and the poses within 5e-3 rad,
  the solver's own float32 sensitivity):
  the same ``ok`` flags; where the inlier masks agree, R and t within
  1e-4; where they differ, only rows whose squared Sampson distance under
  the JAX pose lies within 5% of the threshold, and R and t within 5e-3
  rad (a float32 RANSAC puts a row on the other side of its threshold and
  the refinement builds on it: 2 such rows moved one pair's t by 2e-3
  here, as test_torch_evaluate.py found for the solver alone);
* ``chain_with_scale`` fed the same pair poses: within 1e-4 (fed the
  draw, the chain carries the solver's parity above: the sequence tests
  below);
* ``reconstruct_sequence`` (adaptive keyframes without PGO, and with
  ``pgo``) on the draw: keyframes and tracks identical, the chain's
  rotations within 1e-3 (the solver's parity), the final BA rotations
  within 1e-4, the camera centres within 1e-4 of each other after
  similarity alignment (the monocular gauge), the cost within 1e-3
  relative; and the same with ``pose_solver="cv2"`` in both (the
  reference protocol: OpenCV in JAX, sfm/essential.py in the port, whose
  draws are OpenCV's), the chain's rotations within 1e-3;
* the map recoveries through tests/test_sfm_pipeline.py's failed link
  (2, 3), on a noiseless sequence, both chains fed the JAX solver's poses
  with that link failed, without a warning: skip-pair recovery (the
  reference protocol: OpenCV in JAX, sfm/essential.py in the port) gives
  the JAX trajectory within 1e-4; PnP recovery (JAX: OpenCV's
  solvePnPRansac; the port: sfm/pnp.py) within 2e-3, because the two
  EPnP fits differ on inexact points (test_torch_sfm.py::
  test_epnp_fit_against_cv2_epnp: up to 5e-4 in R and 4.5e-3 in t on the
  same 1000 noisy points) and run here on the chain's float32-
  triangulated map, which is not exact: the recovered camera is 5e-4 from
  the truth in both, on opposite sides; both trajectories within the JAX
  test's ATE 0.08; the unrecoverable link warns;
* ``refine_with_pose_graph``: no-op without redundancy, within 1e-4 of
  JAX's with a failed pair;
* ``cli.reconstruct.main``: a tiny 4c on three fixture frames (--device
  cpu) writes the JAX report's keys and the PLY with ``--pose-solver
  cv2`` (the default) and ``device``; without CUDA the default device
  raises; with
  ``model_match_fn`` monkeypatched in both packages to the same synthetic
  matcher, the report equals the JAX command's (keyframes, matches,
  tracks and observations equal, rotations within 1e-4, centres within
  1e-4 after similarity alignment, the cost within 1e-3 relative).
"""

import json
import os
import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from casmtr_tpu.sfm import pipeline as JP  # noqa: E402
from casmtr_tpu.sfm import reconstruct as JR  # noqa: E402
from casmtr_tpu_torch.sfm import pipeline as TP  # noqa: E402
from casmtr_tpu_torch.sfm import pose as TPose  # noqa: E402
from casmtr_tpu_torch.sfm import reconstruct as TR  # noqa: E402
from tests.test_pose_graph import (drifted_init, make_trajectory,  # noqa
                                   skip_edges)
from tests.test_sfm_pipeline import synth_sequence  # noqa: E402
from tests.test_torch_evaluate import jax_noise  # noqa: E402
from tests.torch_parity import fast_jit, tiny_4c_overrides  # noqa: E402

POSE_ATOL = 1e-4
PNP_ATOL = 2e-3
SOLVER_ATOL = 1e-3
FLIP_RAD = 5e-3
INLIER_MARGIN = 0.05
COST_RTOL = 1e-3
FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "port_io", "megadepth", "Undistorted_SfM", "0000",
                      "images")
REPORT_KEYS = {"n_frames", "keyframes", "n_pairs", "n_matches", "n_tracks",
               "n_obs", "ba_cost", "rms_reproj_px_rho", "poses"}
POSE_KEYS = {"frame", "R", "t", "center"}


JIT_TRIANGULATE = fast_jit(JP.triangulate)


@pytest.fixture
def jax_fast(monkeypatch):
    """The JAX pipeline's jit on fast_jit and its triangulation compiled
    (one compile per shape instead of an eager compile per operation)."""
    monkeypatch.setattr(jax, "jit", fast_jit)
    for mod in (JP, JR):
        monkeypatch.setattr(mod, "triangulate", JIT_TRIANGULATE)


@pytest.fixture
def jax_draw(monkeypatch, jax_fast):
    """The port's pipeline solver on the JAX key's draw for its shape."""
    real = TP.estimate_pose_batch

    def drawn(k0, k1, valid, K0, K1, noise=None, generator=None, **kw):
        B, M = valid.shape
        return real(k0, k1, valid, K0, K1,
                    noise=torch.from_numpy(jax_noise(B, 512, M)), **kw)

    monkeypatch.setattr(TP, "estimate_pose_batch", drawn)


def _sequence(n_frames, noise, seed=0):
    return synth_sequence(np.random.default_rng(seed), n_frames=n_frames,
                          noise=noise)


def _identity(obj):
    return [obj]


def _same_matches(a, b):
    assert list(a) == list(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)


def _same_tracks(a, b):
    assert list(a) == list(b)
    for k in a:
        assert [f for f, _ in a[k]] == [f for f, _ in b[k]]
        for (_, u), (_, v) in zip(a[k], b[k]):
            np.testing.assert_array_equal(u, v)


def _centers(Rs, ts):
    return np.stack([-R.T @ t for R, t in zip(Rs, ts)])


# ------------------------------------------------------- keyframes, tracks

def test_pair_graph_and_keyframes_match_jax():
    for frames, ov in (([0, 2, 5], (1,)), ([0, 1, 2, 3], (1, 2)),
                       (list(range(7)), (1, 2, 3))):
        assert TP.pair_graph(frames, ov) == JP.pair_graph(frames, ov)

    def decay(i, j):
        n = max(0, 200 - 60 * (j - i))
        z = np.zeros((n, 2))
        return z, z, np.ones(n)

    def cliff(i, j):
        n = 200 if j - i <= 3 else 10
        z = np.linspace(0, 1, 2 * n).reshape(n, 2)
        return z, z + 1, np.ones(n)

    for fn, n in ((decay, 10), (cliff, 12)):
        caches = ({}, {})
        kfs = [mod.select_keyframes(n, fn, min_matches=100, max_gap=8,
                                    cache=c)
               for mod, c in zip((JP, TP), caches)]
        assert kfs[0] == kfs[1]
        _same_matches(*caches)


def test_match_pairs_two_ranks_and_tracks_match_jax():
    match_fn, _, _ = _sequence(5, 0.3)
    pairs = JP.pair_graph(list(range(5)), (1, 2))
    merged = {}
    for mod in (JP, TP):
        part1 = mod.match_pairs(match_fn, pairs, world=2, rank=1,
                                gather=_identity)
        merged[mod] = mod.match_pairs(
            match_fn, pairs, world=2, rank=0, min_conf=0.5,
            gather=lambda mine, part1=part1: [mine, part1])
        assert set(merged[mod]) == set(pairs)
    _same_matches(merged[JP], merged[TP])
    single = TP.match_pairs(match_fn, pairs, world=1, rank=0,
                            gather=_identity)
    for k in pairs:
        np.testing.assert_array_equal(single[k][0], merged[TP][k][0])
    for quant in (4.0, 1.0):
        _same_tracks(TP.build_tracks(merged[TP], quant=quant),
                     JP.build_tracks(merged[JP], quant=quant))
    # tests/test_sfm_pipeline.py's hand-made chain through one frame-1 cell
    matches = {(0, 1): (np.array([[8.0, 8.0]]), np.array([[16.0, 16.0]]),
                        np.ones(1)),
               (1, 2): (np.array([[17.0, 17.0]]), np.array([[32.0, 32.0]]),
                        np.ones(1)),
               (0, 2): (np.array([[100.0, 100.0]]),
                        np.array([[120.0, 120.0]]), np.ones(1))}
    _same_tracks(TP.build_tracks(matches), JP.build_tracks(matches))


# ------------------------------------------------------------ pair poses

def _rot_angle(Ra, Rb):
    return 2 * np.arcsin(min(1.0, np.linalg.norm(Ra - Rb) / (2 * 2 ** 0.5)))


def _six(noise):
    """tests/test_pose_graph.py's 6-frame sequence, matched on pairs
    (1, 2) apart: (match_fn, K, centres, pairs, matches)."""
    match_fn, K, gt = _sequence(6, noise)
    pairs = JP.pair_graph(list(range(6)), (1, 2))
    matches = TP.match_pairs(match_fn, pairs, world=1, rank=0,
                             gather=_identity)
    return match_fn, K, gt, pairs, matches


@pytest.fixture(scope="module")
def six():
    """The 6-frame sequence at 0.2 px and the JAX package's device poses of
    all its pairs (one compile of the batch shape the PGO runs reuse)."""
    match_fn, K, gt, pairs, matches = _six(0.2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", fast_jit)
        poses = JP._pair_poses_device(matches, pairs, K, 0.5)
    return match_fn, K, gt, pairs, matches, dict(zip(pairs, poses))


def test_pair_poses_device_matches_jax(six, jax_draw, monkeypatch):
    _, K, _, pairs, matches, want = six
    got = TP._pair_poses_device(matches, pairs, K, 0.5, device="cpu")
    # the pairs two at a time: the same inliers, the poses within the
    # solver's own float32 sensitivity (another batch size rounds its
    # batched products otherwise, and its 5-step polish, started from
    # another of two equal-count hypotheses, ends up to 3.7e-3 away)
    monkeypatch.setattr(TP, "POSE_CHUNK", 2 * TP.N_HYP * 256)
    chunked = TP._pair_poses_device(matches, pairs, K, 0.5, device="cpu")
    for a, b in zip(got, chunked):
        np.testing.assert_array_equal(a[2], b[2])
        assert _rot_angle(a[0], b[0]) <= FLIP_RAD
        assert np.linalg.norm(a[1] - b[1]) <= FLIP_RAD
    thr2 = (0.5 / K[0, 0]) ** 2
    for (i, j), (Rg, tg, ig) in zip(pairs, got):
        Rw, tw, iw = want[(i, j)]
        assert (iw is None) == (ig is None), (i, j)
        if iw is None:
            continue
        diff = iw != ig
        tol = POSE_ATOL if not diff.any() else FLIP_RAD
        assert _rot_angle(Rg, Rw) <= tol, (i, j)
        assert np.linalg.norm(tg - tw) <= tol, (i, j)
        if diff.any():
            mk0, mk1, _ = matches[(i, j)]
            x0 = TPose._normalize(torch.from_numpy(mk0), torch.tensor(K))
            x1 = TPose._normalize(torch.from_numpy(mk1), torch.tensor(K))
            E = TPose._skew(torch.from_numpy(tw)) @ torch.from_numpy(Rw)
            d2 = TPose._sampson(E, x0, x1).numpy()
            assert (np.abs(d2[diff] / thr2 - 1) <= INLIER_MARGIN).all()


def test_chain_with_scale_matches_jax(six, jax_fast):
    """Both chains on the JAX solver's poses of the consecutive pairs (the
    solver's own parity is the test above; the draw's, the sequence tests
    below)."""
    _, K, _, _, matches, poses = six
    frames = list(range(6))
    Rj, tj = JP.chain_with_scale(matches, frames, K, pair_poses=poses)
    Rt, tt = TP.chain_with_scale(matches, frames, K, pair_poses=poses,
                                 device="cpu")
    np.testing.assert_allclose(Rt, Rj, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=POSE_ATOL, rtol=0)


def _compare_results(rj, rt):
    assert rt.keyframes == rj.keyframes
    _same_matches(rj.matches, rt.matches)
    _same_tracks(rj.tracks, rt.tracks)
    np.testing.assert_allclose(rt.problem.cam_rvec.numpy(),
                               np.asarray(rj.problem.cam_rvec),
                               atol=POSE_ATOL, rtol=0)
    assert TR.ate_rmse(TR.camera_centers(rt.problem),
                       JR.camera_centers(rj.problem)) <= POSE_ATOL
    np.testing.assert_allclose(rt.cost, rj.cost, rtol=COST_RTOL)


@pytest.mark.parametrize("pgo", (False, True))
def test_reconstruct_sequence_matches_jax(jax_draw, pgo, request):
    """Without PGO: 7 frames at 0.3 px, adaptive keyframes (max_gap 2);
    with: tests/test_pose_graph.py's 6 frames at 0.2 px."""
    if pgo:
        match_fn, K, gt = _sequence(6, 0.2)
        kw = dict(keyframes=list(range(6)), pgo=True)
        n = 6
        request.getfixturevalue("six")      # its compile, shared
    else:
        match_fn, K, gt = _sequence(7, 0.3)
        kw = dict(min_matches=10_000, max_gap=2)
        n = 7
    rj = JP.reconstruct_sequence(match_fn, n, K, overlaps=(1, 2),
                                 ba_iters=15, pose_solver="device", **kw)
    rt = TP.reconstruct_sequence(match_fn, n, K, overlaps=(1, 2),
                                 ba_iters=15, device="cpu",
                                 pose_solver="device", **kw)
    _compare_results(rj, rt)
    np.testing.assert_allclose(rt.init_Rs, rj.init_Rs, atol=SOLVER_ATOL)
    assert TR.ate_rmse(TR.camera_centers(rt.problem), gt[rt.keyframes]) < 0.1


@pytest.mark.parametrize("pgo", (False, True))
def test_reconstruct_sequence_cv2_matches_jax(jax_fast, pgo):
    """The reference protocol in both (the default): 7 frames at 0.3 px,
    adaptive keyframes (max_gap 2), or 6 frames at 0.2 px with PGO."""
    pytest.importorskip("cv2")
    if pgo:
        match_fn, K, gt = _sequence(6, 0.2)
        kw = dict(keyframes=list(range(6)), pgo=True)
        n = 6
    else:
        match_fn, K, gt = _sequence(7, 0.3)
        kw = dict(min_matches=10_000, max_gap=2)
        n = 7
    rj = JP.reconstruct_sequence(match_fn, n, K, overlaps=(1, 2),
                                 ba_iters=15, **kw)
    rt = TP.reconstruct_sequence(match_fn, n, K, overlaps=(1, 2),
                                 ba_iters=15, device="cpu", **kw)
    _compare_results(rj, rt)
    np.testing.assert_allclose(rt.init_Rs, rj.init_Rs, atol=SOLVER_ATOL)
    np.testing.assert_allclose(rt.init_ts, rj.init_ts, atol=SOLVER_ATOL)
    assert TR.ate_rmse(TR.camera_centers(rt.problem), gt[rt.keyframes]) < 0.1


# ------------------------------------------------------------- recoveries

def _failing_batch(real):
    """``real`` with the link (2, 3) failed (tests/test_sfm_pipeline.py's
    recovery tests)."""
    def fake(matches, pairs, *a, **k):
        out = real(matches, pairs, *a, **k)
        return [TP._pose_failed(i, j, 0) if (i, j) == (2, 3) else o
                for (i, j), o in zip(pairs, out)]
    return fake


@pytest.mark.parametrize("path", ("pnp", "skip_pair"))
def test_recoveries_match_jax(six, jax_fast, monkeypatch, path):
    """Both chains on the JAX solver's poses of a noiseless 6-frame
    sequence with the link (2, 3) failed: the JAX chain recovers through
    OpenCV (solvePnPRansac, or the reference protocol on the skip pair),
    the port's through sfm/pnp.py, or its own protocol
    (sfm/essential.py)."""
    pytest.importorskip("cv2")
    _, K, _, pairs, matches = _six(0.0)
    gt = _sequence(6, 0.0)[2]
    frames = list(range(6))
    poses = dict(zip(pairs, JP._pair_poses_device(matches, pairs, K, 0.5)))
    poses[(2, 3)] = JP._pose_failed(2, 3, 0)
    if path == "skip_pair":
        for mod in (JP, TP):
            monkeypatch.setattr(mod, "_pnp_pose", lambda *a, **k: None)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        Rj, tj = JP.chain_with_scale(matches, frames, K, pair_poses=poses)
        Rt, tt = TP.chain_with_scale(matches, frames, K, pair_poses=poses,
                                     device="cpu")
    tol = PNP_ATOL if path == "pnp" else POSE_ATOL
    np.testing.assert_allclose(Rt, Rj, atol=tol, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=tol, rtol=0)
    assert TR.ate_rmse(_centers(Rt, tt), gt) < 0.08


def test_unrecoverable_link_warns(monkeypatch):
    match_fn, K, _ = _sequence(5, 0.0)
    frames = list(range(5))
    matches = TP.match_pairs(match_fn, TP.pair_graph(frames, (1,)))
    monkeypatch.setattr(TP, "_pair_poses_device",
                        _failing_batch(TP._pair_poses_device))
    monkeypatch.setattr(TP, "_pnp_pose", lambda *a, **k: None)
    with pytest.warns(RuntimeWarning, match="unreliable"):
        TP.chain_with_scale(matches, frames, K, device="cpu",
                            pose_solver="device")


def test_refine_with_pose_graph_matches_jax():
    rng = np.random.default_rng(5)
    C = 8
    Rs, ts = make_trajectory(C, rng)
    pair_poses = {}
    for i, j in skip_edges(C, (1, 2)):
        Rij = Rs[j] @ Rs[i].T
        tij = ts[j] - Rij @ ts[i]
        pair_poses[(i, j)] = (Rij, tij / np.linalg.norm(tij),
                              np.ones(60, bool))
    pair_poses[(0, 2)] = (np.eye(3), np.array([0, 0, 1e-3]), None)
    R0, t0 = drifted_init(Rs, ts, rng)
    Rj, tj = JP.refine_with_pose_graph(R0, t0, pair_poses, list(range(C)))
    Rt, tt = TP.refine_with_pose_graph(R0, t0, pair_poses, list(range(C)),
                                       device="cpu")
    np.testing.assert_allclose(Rt, Rj, atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=POSE_ATOL, rtol=0)
    chain = {k: v for k, v in pair_poses.items() if k[1] - k[0] == 1}
    R2, t2 = TP.refine_with_pose_graph(R0, t0, chain, list(range(C)),
                                       device="cpu")
    assert R2 is R0 and t2 is t0


# -------------------------------------------------------------- the command

@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for name in sorted(os.listdir(FRAMES))[:3]:
        shutil.copy(os.path.join(FRAMES, name), d / name)
    return str(d)


def test_reconstruct_cli_tiny_model(frames_dir, tmp_path, capsys):
    from casmtr_tpu_torch.cli import reconstruct as C
    out, ply = str(tmp_path / "recon.json"), str(tmp_path / "recon.ply")
    argv = [frames_dir, "--fx", "100", "--fy", "100", "--cx", "48",
            "--cy", "32", "--resize", "64", "--thr", "-1", "--ba-iters", "3",
            "--overrides-json",
            json.dumps(tiny_4c_overrides(64, zero_thresholds=True)),
            "--out", out, "--ply", ply]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        dev = C.main(argv + ["--pose-solver", "device", "--device", "cpu"])
    assert set(dev) == REPORT_KEYS and dev["n_frames"] == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            C.main(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        report = C.main(argv + ["--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) == REPORT_KEYS
    assert report["n_frames"] == 3 and report["n_tracks"] > 0
    assert all(set(p) == POSE_KEYS for p in report["poses"])
    with open(ply) as f:
        head = f.read().split("end_header\n")
    n_points = int(head[0].split("element vertex ")[1].split()[0])
    assert n_points == report["n_tracks"]
    assert len(head[1].splitlines()) == n_points
    assert "wrote" in capsys.readouterr().out


def test_reconstruct_cli_matches_jax(six, tmp_path, monkeypatch, jax_draw):
    """Both commands with --pgo on the same synthetic matcher (the 6-frame
    sequence) over six copies of the fixture's frames (the JAX command's
    model init stubbed: no model runs)."""
    import casmtr_tpu.cli as jcli
    import casmtr_tpu.models as jmodels
    from casmtr_tpu.cli import reconstruct as JC
    from casmtr_tpu_torch.cli import reconstruct as TC
    d = tmp_path / "six"
    d.mkdir()
    names = sorted(os.listdir(FRAMES))
    for a in range(6):       # the fixture's four frames, two of them twice
        shutil.copy(os.path.join(FRAMES, names[a % 4]), d / f"{a:04d}.jpg")
    match_fn, K, _, _, _, _ = six

    class _Stub:
        def init(self, *a, **k):
            return {}

    monkeypatch.setattr(jcli, "enable_compile_cache", lambda *a: None)
    monkeypatch.setattr(jmodels, "build_model", lambda *a, **k: _Stub())
    for mod in (JP, TP):
        monkeypatch.setattr(mod, "model_match_fn",
                            lambda *a, **k: match_fn)
    common = [str(d), "--fx", str(K[0, 0]), "--fy", str(K[1, 1]),
              "--cx", str(K[0, 2]), "--cy", str(K[1, 2]), "--resize", "64",
              "--keyframes", *map(str, range(6)), "--pgo"]
    JC.main(common + ["--pose-solver", "device",
                      "--out", str(tmp_path / "j.json")])
    got = TC.main(common + ["--device", "cpu", "--pose-solver", "device",
                            "--out", str(tmp_path / "t.json")])
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    assert set(got) == set(want) == REPORT_KEYS
    for k in ("n_frames", "keyframes", "n_pairs", "n_matches", "n_tracks",
              "n_obs"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["ba_cost"], want["ba_cost"],
                               rtol=COST_RTOL)
    for pg, pw in zip(got["poses"], want["poses"]):
        assert pg["frame"] == pw["frame"]
        np.testing.assert_allclose(pg["R"], pw["R"], atol=POSE_ATOL)
    assert TR.ate_rmse(np.array([p["center"] for p in got["poses"]]),
                       np.array([p["center"] for p in want["poses"]])
                       ) <= POSE_ATOL
