"""The port's commands and the Matcher's paths, on the CPU with tiny models:

* ``Matcher.match`` and ``match_batch`` on image paths (str and
  os.PathLike) bit-identical to the same calls on the arrays
  ``data/io._imread`` returns for those files;
* ``cli.evaluate.main``: its --thr / --img-size / --overrides-json reach
  ``run_eval`` as in tests/test_evaluate_cli.py (``--pose-solver``
  defaulting to ``cv2``, the reference protocol), and end-to-end runs
  from files (``--device cpu``) with ``--pose-solver cv2`` and
  ``device`` print the result JSON;
* ``cli.match_pair.main``: the number of matches printed and the figure
  written to ``--out`` (a PNG of both images side by side);
* ``cli.train.main`` end to end on a fake MegaDepth scene: 2 steps,
  validation, checkpoints and config.json, then ``--stage 2 --resume``
  from them (tests/test_train_cli.py's test in the port), its first step's
  loss equal to the port's ``make_train_step`` on the same first batch;
  ``--dist`` without a launcher's environment raises (the data-parallel
  command runs in tests/test_torch_distributed.py).
"""

import json
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

from casmtr_tpu_torch.cli import evaluate as E  # noqa: E402
from casmtr_tpu_torch.cli import match_pair as MP  # noqa: E402
from casmtr_tpu_torch.cli import train as T  # noqa: E402
from casmtr_tpu_torch.data.io import _imread  # noqa: E402
from casmtr_tpu_torch.serving import Matcher  # noqa: E402
from casmtr_tpu_torch.utils.plotting import GAP  # noqa: E402
from tests.test_data_layer import make_fake_scene  # noqa: E402
from tests.torch_parity import tiny_4c_overrides  # noqa: E402


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    make_fake_scene(d, scene_id="0000", n_images=4, n_pairs=4)
    make_fake_scene(d, scene_id="0001", n_images=4, n_pairs=3)
    (d / "train_list.txt").write_text("0000\n0001\n")
    (d / "val_list.txt").write_text("0001\n")
    (d / "test_list.txt").write_text("0000\n")
    return str(d)


def _overrides(data_dir, n_samples=1):
    ov = tiny_4c_overrides(64)
    ov["dataset"] = {
        f"{s}_{k}": v for s in ("train", "val", "test") for k, v in (
            ("data_root", data_dir), ("npz_root", data_dir),
            ("list_path", os.path.join(data_dir, f"{s}_list.txt")))}
    ov["dataset"].update(
        trainval_data_source="MegaDepth", test_data_source="MegaDepth",
        min_overlap_score_train=0.0, min_overlap_score_test=0.0,
        mgdpt_img_resize=64, mgdpt_df=32)
    ov["trainer"] = {"n_samples_per_subset": n_samples, "warmup_step": 2,
                     "canonical_bs": 1, "canonical_lr": 1e-4}
    return ov


def test_matcher_takes_paths(scene_dir):
    m = Matcher("outdoor_casmtr_4c", bucket=64, df=32, thr=0.0,
                overrides=tiny_4c_overrides(64, zero_thresholds=True),
                device="cpu")
    p0 = os.path.join(scene_dir, "imgs", "0000_0.jpg")
    p1 = pathlib.Path(scene_dir) / "imgs" / "0000_1.jpg"
    a = m.match(p0, p1)
    b = m.match(_imread(p0, gray=False), _imread(p1, gray=False))
    assert len(a.mconf) > 0
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    a = m.match_batch([(p0, p1), (p1, p0)])
    b = m.match_batch([(_imread(p0, False), _imread(p1, False)),
                       (_imread(p1, False), _imread(p0, False))])
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


def test_evaluate_cli_overrides_reach_run_eval(monkeypatch, capsys):
    seen = {}

    def fake_run_eval(cfg, model, dataset=None, max_pairs=None,
                      profiler_name=None, dump_dir=None,
                      pose_solver="cv2", device=None):
        seen.update(cfg=cfg, max_pairs=max_pairs, pose_solver=pose_solver,
                    device=device)
        return {"auc@5": 0.0}

    monkeypatch.setattr(E, "run_eval", fake_run_eval)
    E.main(["--model", "outdoor_casmtr_4c", "--img-size", "64",
            "--thr", "0.123", "--max-pairs", "3", "--device", "cpu",
            "--overrides-json", json.dumps(tiny_4c_overrides(64))])
    cfg = seen["cfg"]
    assert cfg.loftr.match_coarse.thr == pytest.approx(0.123)
    assert cfg.dataset.mgdpt_img_resize == 64
    assert cfg.loftr.coarse.d_model == 16
    assert seen["max_pairs"] == 3 and seen["pose_solver"] == "cv2"
    assert seen["device"] == "cpu"
    assert "auc@5" in capsys.readouterr().out


def test_evaluate_cli_from_files(scene_dir, capsys):
    ov = _overrides(scene_dir)
    keys = {"auc@5", "auc@10", "auc@20", "prec@1e-04"}
    for solver in ("cv2", "device"):
        res = E.main(["--pose-solver", solver, "--device", "cpu",
                      "--max-pairs", "1", "--profiler", "inference",
                      "--overrides-json", json.dumps(ov)])
        out = capsys.readouterr().out
        assert set(res) == keys
        assert "Data loading" in out
        printed = json.loads(out[out.index("{"):])
        assert printed == {k: float(v) for k, v in res.items()}


def test_match_pair_cli(scene_dir, capsys, tmp_path):
    p0 = os.path.join(scene_dir, "imgs", "0001_0.jpg")
    p1 = os.path.join(scene_dir, "imgs", "0001_2.jpg")
    ov = json.dumps(tiny_4c_overrides(64, zero_thresholds=True))
    out = str(tmp_path / "result.png")
    mk0, mk1, mconf = MP.main([p0, p1, "--resize", "64", "--thr", "0",
                               "--device", "cpu", "--overrides-json", ov,
                               "--out", out])
    printed = capsys.readouterr().out
    assert f"{len(mk0)} matches" in printed and f"wrote {out}" in printed
    assert len(mk0) == len(mk1) == len(mconf) > 0
    fig = cv2.imread(out, cv2.IMREAD_UNCHANGED)
    h0, w0 = _imread(p0, False).shape[:2]
    h1, w1 = _imread(p1, False).shape[:2]
    assert fig.shape == (max(h0, h1), w0 + w1 + GAP, 4)


def test_train_cli_end_to_end_and_stage_resume(scene_dir, tmp_path,
                                                monkeypatch):
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.data.module import MultiSceneDataModule
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.optim import scaled_lr
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_

    losses = []
    make = T.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def fn(state, batch):
            state, s = step(state, batch)
            losses.append(float(s["loss"]))
            return state, s
        return fn

    monkeypatch.setattr(T, "make_train_step", recording)
    ov = _overrides(scene_dir)
    run1 = str(tmp_path / "run1")
    common = ["--model", "outdoor_casmtr_4c", "--epochs", "1",
              "--num-workers", "2", "--log-every", "1", "--max-val-pairs",
              "1", "--sanity-val-steps", "1", "--device", "cpu",
              "--overrides-json", json.dumps(ov)]
    out = T.main(common + ["--run-dir", run1, "--stage", "1"])
    assert out["step"] == 2 and "auc@10" in out["val"] and len(losses) == 2
    assert os.path.exists(os.path.join(run1, "config.json"))
    assert os.listdir(os.path.join(run1, "ckpts"))

    # the command's first step against the port's step on the same batch
    cfg = override(build_config(
        "outdoor_casmtr_4c", "megadepth_trainval_704",
        {"trainer": {"seed": 66}, "loftr": {"training_stage": 1}}), ov)
    batch = next(iter(MultiSceneDataModule(cfg).train_loader(1, 1)))
    model = build_model(cfg.loftr)
    init_random_(model, torch.Generator().manual_seed(66))
    state, tx = init_train_state(model, cfg, 2, scaled_lr(
        cfg.trainer, 1, "MegaDepth"), device="cpu")
    _, scalars = make(model, cfg, tx, device="cpu")(
        state, T.device_batch(batch, "cpu"))
    assert float(scalars["loss"]) == losses[0]

    run2 = str(tmp_path / "run2")
    out = T.main(common + ["--run-dir", run2, "--stage", "2", "--resume",
                           os.path.join(run1, "ckpts")])
    assert out["step"] == 4
    assert os.listdir(os.path.join(run2, "ckpts"))
    # --dist reads a launcher's environment, which this process lacks
    with pytest.raises(ValueError, match="RANK"):
        T.main(common + ["--run-dir", run2, "--dist"])
