"""Data-parallel training of the port over a gloo process group of two
CPU processes (tests/torch_dist_worker.py), against the port's one-process
step on the concatenated batch, at tests/test_parallel_train.py's
tolerances: loss rtol 1e-5, grad_norm rtol 1e-3, parameters within 5e-5 +
1e-4 |p| but for 0.5 % (none beyond 2 lr), BatchNorm statistics rtol 1e-4 /
atol 1e-5.

One world runs every check of ``checks``: the tiny 4c and 2c steps and a
gumbel-detector step on two shifted pairs (tests/test_torch_global_batch.
pair_batch2, the batch whose one-process step equals the JAX step), a
NaN in one rank's pair, the d2d filter's saliency, ``mesh.all_reduce_sum``
and its gradient, ``comm``'s gathers with unequal payloads,
``sfm.pipeline.match_pairs``'s partition and merge (7 pairs, a padded
duplicate), ``gather_metrics`` with a pair seen on both ranks (the last
wins), the logger's level on each rank, and the landmark-sharded BA, dense
and CG, against the one-process BA at tests/test_sfm.py's tolerances.  A second world runs ``cli.train`` with
``--dist-coordinator`` on the fixture scenes of tests/test_torch_commands.
py; ``dryrun_multichip(2)`` spawns its own.  Every world takes a free port
from the OS and has its own timeout.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from casmtr_tpu_torch.parallel import dryrun, mesh  # noqa: E402
from tests import torch_dist_worker as W  # noqa: E402
from tests.test_torch_detector import _detector_overrides  # noqa: E402
from tests.test_torch_global_batch import pair_batch2  # noqa: E402
from tests.test_torch_train import _step_overrides  # noqa: E402
from tests.torch_parity import tiny_2c_overrides  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 300
LR = 1e-3


def _gumbel_overrides():
    """The tiny 4c step with the learnable head and the gumbel detector on
    its 1/4 level."""
    ov = _detector_overrides()
    ov["loftr"]["coarse2"]["detector_mode"] = "gumbel"
    return ov


STEPS = {"4c": _step_overrides(), "2c": tiny_2c_overrides(64),
         "gumbel": _gumbel_overrides()}
BA_RUNS = {"dense": dict(iters=5),
           "cg": dict(iters=5, solver="cg", cg_iters=150, cg_tol=1e-8)}
BA_RVEC_ATOL = {"dense": 1e-4, "cg": 1e-2}
METRICS = [  # pair "a#b" on both ranks: rank 1's (the later) result counts
    {"identifiers": ["a#b", "c#d"], "R_errs": [50.0, 90.0],
     "t_errs": [50.0, 90.0], "epi_errs": [np.ones(1), np.ones(1)],
     "inliers": [np.zeros(1, bool)] * 2},
    {"identifiers": ["a#b"], "R_errs": [0.5], "t_errs": [0.5],
     "epi_errs": [np.full(1, 1e-5)], "inliers": [np.ones(1, bool)]}]


def _spawn(mode, spec, tmp):
    """``dryrun.spawn_world`` of the worker in ``mode`` on ``spec`` (saved
    in ``tmp``, the processes' working directory), without a launcher's
    environment, each world within TIMEOUT_S."""
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(spec, spec_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}

    def argv(r, port, out):
        return [sys.executable, os.path.join(REPO, "tests",
                                             "torch_dist_worker.py"),
                mode, spec_path, str(r), str(WORLD), str(port), out]
    return dryrun.spawn_world(WORLD, argv, TIMEOUT_S, env=env, cwd=tmp)


def ba_problem(seed=0, C=3, P=40, noise=0.5, perturb=0.02):
    """tests/test_sfm.make_problem's scene in numpy, projected by the port."""
    from casmtr_tpu_torch.sfm.geometry import project
    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                    rng.uniform(5, 9, P)], -1).astype(np.float32)
    rv = np.stack([[0.0, 0.04 * c, 0.0] for c in range(C)]).astype(np.float32)
    tv = np.stack([[-0.4 * c, 0.02 * c, 0.0] for c in range(C)]
                  ).astype(np.float32)
    oc = np.repeat(np.arange(C), P)
    op = np.tile(np.arange(P), C)
    uv = project(*(torch.from_numpy(a) for a in (rv[oc], tv[oc], pts[op], K)))
    uv = uv.numpy() + rng.normal(0, noise, (C * P, 2)).astype(np.float32)
    return {"cam_rvec": (rv + rng.normal(0, perturb, rv.shape)
                         ).astype(np.float32),
            "cam_tvec": (tv + rng.normal(0, perturb, tv.shape)
                         ).astype(np.float32),
            "points": (pts + rng.normal(0, perturb * 5, pts.shape)
                       ).astype(np.float32),
            "K": K, "obs_cam": oc.astype(np.int64),
            "obs_pt": op.astype(np.int64), "obs_uv": uv.astype(np.float32),
            "obs_valid": np.ones(C * P, bool)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The checks world; the one-process references are computed here
    while it runs."""
    from casmtr_tpu_torch.sfm import ba
    batch = pair_batch2()
    steps = {k: {"overrides": ov, "batch": batch, "seed": 1, "lr": LR}
             for k, ov in STEPS.items()}
    problem = ba_problem()
    feat = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (WORLD, 256, 8)).astype(np.float32))
    feat[1] *= 3.0   # the two rows' ranges differ
    nan_batch = {k: v.copy() for k, v in batch.items()}
    nan_batch["image0"][1, 5, 7, 1] = np.nan   # rank 1's pair only
    from casmtr_tpu_torch.ops.nms import d2d_saliency
    with _spawn("checks", {"steps": steps, "metrics": METRICS,
                           "nan_batch": nan_batch, "d2d": {"feat": feat},
                           "ba_problem": problem, "ba_runs": BA_RUNS},
                str(tmp_path_factory.mktemp("world"))) as wait:
        refs = {k: W.train_step(s, batch) for k, s in steps.items()}
        p = ba.BAProblem(**{k: torch.from_numpy(v)
                            for k, v in problem.items()})
        ba_refs = {k: ba.run_ba(p, **kw) for k, kw in BA_RUNS.items()}
        d2d = d2d_saliency(feat, (16, 16))
        ranks, logs = wait()
    return {"ranks": ranks, "refs": refs, "ba": ba_refs, "d2d": d2d,
            "logs": logs}


@pytest.mark.parametrize("name", list(STEPS))
def test_world2_step_equals_one_process_step(world, name):
    """Each rank's step equals the one-process step on the concatenated
    batch (``dryrun.check_train``'s CPU gates): every scalar, the global
    loss terms and counts and the clip norm, the update, the same on every
    rank, and the BatchNorm statistics."""
    want = world["refs"][name]
    dryrun.check_train(name, [r["steps"][name] for r in world["ranks"]],
                       want, card=False, lr=LR)
    if name == "gumbel":
        assert want["scalars"]["loss_4c_det"] > 0


def test_world2_d2d_saliency_is_the_global_batch_s(world):
    """The d2d filter's min-max runs over the global batch: each rank's
    row equals the one-process saliency's."""
    for rank, res in enumerate(world["ranks"]):
        torch.testing.assert_close(res["d2d"], world["d2d"][rank:rank + 1],
                                   rtol=0, atol=1e-6)


def test_world2_nan_on_one_rank_skips_on_both(world):
    """A NaN in rank 1's pair makes the global loss non-finite: both ranks
    skip the update and keep every parameter and BatchNorm statistic."""
    for res in world["ranks"]:
        scalars, kept = res["nan_step"]
        assert not np.isfinite(scalars["loss"]) and kept


def test_world2_all_reduce_sum_and_its_gradient(world):
    """y = x_0 + x_1 on both ranks (x_r = r + 1); with rank r's loss
    (r + 1) y, each x's gradient is the summed 1 + 2."""
    assert [r["all_reduce_sum"] for r in world["ranks"]] == [(3.0, 3.0)] * 2


def test_world2_comm_gathers_unequal_payloads(world):
    for rank, res in enumerate(world["ranks"]):
        c = res["comm"]
        assert (res["world"], res["rank"]) == (WORLD, rank)
        assert c["obj_ranks"] == [0, 1]
        assert c["obj_lens"] == [7, 7 + 137]
        assert c["reduce_mean"] == pytest.approx({"a": 0.5, "b": 2.0})
        assert c["reduce_sum"] == pytest.approx({"a": 1.0})
        assert c["arrays"] == [[0, 0], [1, 3]]
        assert c["gather0_len"] == (2 if rank == 0 else 0)


def test_world2_match_pairs_partition_and_merge(world):
    """Every pair once, on both ranks alike, the padded duplicate of the
    7-pair split merged away."""
    want = {(a, a + 1): 3 + (2 * a + 1) % 4 for a in range(6)}
    want[(0, 3)] = 3 + 3 % 4
    for res in world["ranks"]:
        assert res["pairs"] == want


def test_world2_gather_metrics_dedup(world):
    """The gathered lists in rank order; aggregate_metrics keeps the
    later 'a#b' (rank 1's), as tests/test_parallel_train.py's test."""
    from casmtr_tpu_torch.utils.metrics import aggregate_metrics
    for res in world["ranks"]:
        m = res["metrics"]
        assert m["identifiers"] == ["a#b", "c#d", "a#b"]
        out = aggregate_metrics(m, epi_err_thr=5e-4)
        assert out["auc@5"] > 0.0
        np.testing.assert_allclose(out["prec@5e-04"], 0.5)


def test_logger_logs_errors_only_off_rank_zero(world):
    import logging
    assert [r["log_level"] for r in world["ranks"]] == [logging.INFO,
                                                        logging.ERROR]


@pytest.mark.parametrize("solver", list(BA_RUNS))
def test_world2_sharded_ba_matches_single(world, solver):
    """The landmark-sharded BA: the ranks' costs within 1e-4 of each other
    and 1e-3 of the one-process BA's, the camera rotations within 1e-4
    (dense) or 1e-2 (CG, inexact steps) of its; the two ranks hold
    disjoint landmarks."""
    q1, c1 = world["ba"][solver]
    runs = [r["ba"][solver] for r in world["ranks"]]
    np.testing.assert_allclose(runs[0]["cost"], runs[1]["cost"], rtol=1e-4)
    for run in runs:
        np.testing.assert_allclose(run["cost"], float(c1), rtol=1e-3)
        np.testing.assert_allclose(run["cam_rvec"].numpy(),
                                   q1.cam_rvec.numpy(),
                                   atol=BA_RVEC_ATOL[solver])
    assert not set(runs[0]["pts"]) & set(runs[1]["pts"])


def test_world2_train_command(tmp_path):
    """``cli.train`` with --dist-coordinator on two processes: both finish,
    each reads its own scene, only rank 0 writes config.json and the
    checkpoints, rank 1 logs nothing at INFO, and the first loss is
    ``make_train_step``'s on the global batch (the two ranks' first
    batches) in one process."""
    pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    from casmtr_tpu_torch.cli.train import device_batch
    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.data.module import MultiSceneDataModule
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.optim import scaled_lr
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    from tests.test_data_layer import make_fake_scene
    from tests.test_torch_commands import _overrides

    d = tmp_path / "scenes"
    d.mkdir()
    make_fake_scene(d, scene_id="0000", n_images=4, n_pairs=4)
    make_fake_scene(d, scene_id="0001", n_images=4, n_pairs=3)
    (d / "train_list.txt").write_text("0000\n0001\n")
    (d / "val_list.txt").write_text("0001\n")
    ov = _overrides(str(d), n_samples=2)
    run = str(tmp_path / "run")
    argv = ["--model", "outdoor_casmtr_4c", "--run-dir", run, "--epochs",
            "1", "--stage", "1", "--num-workers", "0", "--log-every", "1",
            "--max-val-pairs", "1", "--sanity-val-steps", "1", "--device",
            "cpu", "--overrides-json", json.dumps(ov)]
    with _spawn("train", {"argv": argv}, str(tmp_path / "world")) as wait:
        cfg = override(build_config(
            "outdoor_casmtr_4c", "megadepth_trainval_704",
            {"trainer": {"seed": 66}, "loftr": {"training_stage": 1}}), ov)
        firsts = [next(iter(MultiSceneDataModule(
            cfg, world_size=WORLD, rank=r).train_loader(1, 0)))
            for r in range(WORLD)]
        batch = {k: torch.cat([device_batch(b, "cpu")[k] for b in firsts])
                 for k in device_batch(firsts[0], "cpu")}
        model = build_model(cfg.loftr)
        init_random_(model, torch.Generator().manual_seed(66))
        state, tx = init_train_state(model, cfg, 2, scaled_lr(
            cfg.trainer, WORLD, "MegaDepth"), device="cpu")
        _, scalars = make_train_step(model, cfg, tx, device="cpu")(state,
                                                                   batch)
        ranks, logs = wait()
    for r, res in enumerate(ranks):
        assert res["step"] == 2 and len(res["losses"]) == 2
        assert "auc@10" in res["val"]
        np.testing.assert_allclose(res["losses"][0], float(scalars["loss"]),
                                   rtol=1e-5, atol=1e-6)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert sorted(ranks[0]["scenes"] + ranks[1]["scenes"]) == ["0000",
                                                                "0001"]
    assert ranks[0]["writes"] and set(ranks[0]["writes"]) == {
        "config", "checkpoint"}
    assert ranks[1]["writes"] == []
    assert os.path.exists(os.path.join(run, "config.json"))
    assert os.listdir(os.path.join(run, "ckpts"))
    assert " INFO " in logs[0] and " INFO " not in logs[1]


def test_dryrun_multichip_2():
    """The four graph families at world 2 against one process (the
    function's own gates, module docstring of parallel/dryrun.py)."""
    report = dryrun.dryrun_multichip(WORLD, "cpu", timeout_s=TIMEOUT_S)
    assert set(report) == set(dryrun.FAMILIES)
    assert report["eval forward"]["matches"] > 0


def test_no_group_is_one_process():
    """Without a group nothing couples: ``global_batch`` is a no-op, the
    world is one process, and ``--dist`` without a launcher's environment
    raises before starting anything."""
    assert mesh.group() is None and mesh.world_size() == 1
    with mesh.global_batch():
        assert mesh.batch_group() is None
    rows = mesh.shard_rows({"x": np.arange(6)[:, None]}, rnk=1, world=3)
    assert rows["x"].ravel().tolist() == [2, 3]
    with pytest.raises(ValueError, match="RANK"):
        mesh.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="--dist-num-processes"):
        mesh.init_distributed("localhost:1", device="cpu")
