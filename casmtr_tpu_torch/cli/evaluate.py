"""Pose evaluation of a matcher over a dataset of pairs (counterpart of
casmtr_tpu/cli/evaluate.py): the served forward on each batch, the pose of
each pair from its final matches, then pose AUC @5/10/20 and epipolar
precision over the dataset.

    python -m casmtr_tpu_torch.cli.evaluate --model outdoor_casmtr_4c \
        --data megadepth_test_1500 --ckpt CKPT

reads the test split of the data recipe from disk (``data/module.
MultiSceneDataModule``; point it elsewhere with ``--overrides-json '{"dataset":
{"test_data_root": ..., "test_npz_root": ..., "test_list_path": ...}}'``).

``--pose-solver cv2`` (the default, as in the JAX command) is the reference
protocol: each pair posed on the host by ``utils/metrics.
compute_pose_errors``, essential-matrix RANSAC and ``recoverPose`` by the
port's own solver (``sfm/essential.py``, no OpenCV; the name keeps the JAX
command's).  ``device`` poses every pair of a batch at once on the card
(``sfm.pose.estimate_pose_batch``).  ``run_eval`` also
takes a caller's own ``dataset``, whose samples are dicts of numpy arrays:
image0 and image1 [H, W, 3] in [0, 1], K0 and K1 [3, 3], T_0to1 [4, 4],
optionally mask0/mask1, scale0/scale1 and ``pair_names``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from casmtr_tpu_torch.config import Config
from casmtr_tpu_torch.config import override as cfg_override
from casmtr_tpu_torch.configs import build_config
from casmtr_tpu_torch.data.loader import DataLoader
from casmtr_tpu_torch.data.module import MultiSceneDataModule
from casmtr_tpu_torch.models import build_model
from casmtr_tpu_torch.serving import configure_card, resolve_device
from casmtr_tpu_torch.sfm.pose import estimate_pose_batch
from casmtr_tpu_torch.utils import metrics as M
from casmtr_tpu_torch.utils.profiler import build_profiler
from casmtr_tpu_torch.weights import init_random_

MODEL_KEYS = ("image0", "image1", "mask0", "mask1", "scale0", "scale1")


def _identifier(batch: Dict, b: int, metrics: Dict) -> str:
    """The pair's names joined, else a running id unique in the run (one
    process: the JAX package's ids of process 0)."""
    if "pair_names" in batch:
        return "#".join(batch["pair_names"][b])
    return f"r0pair{len(metrics['identifiers'])}"


def evaluate_batch_outputs(out_np: Dict, batch: Dict, cfg: Config,
                           metrics: Dict) -> None:
    """Pose each pair of the batch by the reference protocol on the host
    (``utils/metrics.compute_pose_errors`` on its valid final matches) and
    append its identifier, epipolar errors, rotation and translation
    errors and inliers to ``metrics``."""
    B = batch["K0"].shape[0]
    b_ids, valid = out_np["b_ids"], out_np["valid"]
    for b in range(B):
        sel = valid & (b_ids == b)
        mk0, mk1 = out_np["mkpts0"][sel], out_np["mkpts1"][sel]
        T = batch["T_0to1"][b]
        K0, K1 = batch["K0"][b], batch["K1"][b]
        epi = M.compute_epipolar_errors(mk0, mk1, T, K0, K1)
        R_err, t_err, inl = M.compute_pose_errors(
            mk0, mk1, T, K0, K1, pixel_thr=cfg.trainer.ransac_pixel_thr,
            conf=cfg.trainer.ransac_conf)
        metrics["identifiers"].append(_identifier(batch, b, metrics))
        metrics["epi_errs"].append(epi)
        metrics["R_errs"].append(R_err)
        metrics["t_errs"].append(t_err)
        metrics["inliers"].append(inl)


def _device_pose_metrics(out_np: Dict, batch: Dict, cfg: Config,
                         metrics: Dict, pose_fn, device) -> None:
    """Pose every pair of the batch at once with ``pose_fn`` (the device
    solver: the whole fixed-capacity match buffer, one row mask per pair),
    and append each pair's identifier, epipolar errors (numpy, on the
    host), rotation and translation errors (inf where the solver gives up)
    and inliers to ``metrics``."""
    B = batch["K0"].shape[0]
    b_ids, valid = out_np["b_ids"], out_np["valid"]
    sel_b = valid[None, :] & (b_ids[None, :] == np.arange(B)[:, None])
    M_tot = valid.shape[0]

    def dev(x):
        return torch.from_numpy(np.array(x)).to(device)

    res = pose_fn(dev(np.broadcast_to(out_np["mkpts0"], (B, M_tot, 2))),
                  dev(np.broadcast_to(out_np["mkpts1"], (B, M_tot, 2))),
                  dev(sel_b), dev(batch["K0"]).float(),
                  dev(batch["K1"]).float())
    ok = res.ok.cpu().numpy()
    Rs, ts = res.R.cpu().numpy(), res.t.cpu().numpy()
    inl = res.inliers.cpu().numpy()
    for b in range(B):
        sel = sel_b[b]
        epi = M.compute_epipolar_errors(
            out_np["mkpts0"][sel], out_np["mkpts1"][sel],
            batch["T_0to1"][b], batch["K0"][b], batch["K1"][b])
        if ok[b]:
            t_err, r_err = M.relative_pose_error(batch["T_0to1"][b], Rs[b],
                                                 ts[b])
        else:
            t_err = r_err = np.inf
        metrics["identifiers"].append(_identifier(batch, b, metrics))
        metrics["epi_errs"].append(epi)
        metrics["R_errs"].append(r_err)
        metrics["t_errs"].append(t_err)
        metrics["inliers"].append(inl[b][sel])


def _model_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The model's inputs of a numpy batch on ``device``: images and scales
    float32, masks bool, the NHWC layout kept (the models take NHWC)."""
    out = {}
    for k in MODEL_KEYS:
        v = batch.get(k)
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.bool() if k.startswith("mask") else t.float()
                      ).to(device)
    return out


def run_eval(cfg: Config, model: torch.nn.Module, dataset=None,
             max_pairs: Optional[int] = None,
             profiler_name: Optional[str] = None,
             dump_dir: Optional[str] = None,
             pose_solver: str = "cv2", device=None,
             loader=None, on_batch=None) -> Dict:
    """Evaluate ``model`` (a port model of ``cfg.loftr``) on ``dataset``
    (None: the test split of ``cfg.dataset`` read from disk), one pair per
    batch, or on the batches of ``loader`` when given (the training
    command's validation loader), at most ``max_pairs`` pairs: {"auc@5",
    "auc@10", "auc@20", "prec@5e-04" (cfg.trainer.epi_err_thr)}, or {}
    without pairs.  Runs on the card
    (``device`` None, with the Matcher's process-wide flags,
    ``serving.configure_card``) or on ``device``; the model is moved there
    and put in eval mode.  ``profiler_name`` "inference" prints the time
    of the matching, of the pose and of the wait for the loader's next
    batch ("Data loading") per region; ``dump_dir`` receives the
    final matches of every batch (pred_eval.npy); ``on_batch(n, batch,
    out_np, metrics)`` is called after each batch is scored, with ``n``
    the pairs before it (the training command's figures).  ``pose_solver``
    "cv2" poses each pair by the reference protocol on the host
    (``evaluate_batch_outputs``), "device" every pair of a batch at once
    on ``device`` (``sfm.pose.estimate_pose_batch``)."""
    if pose_solver not in ("cv2", "device"):
        raise ValueError(f"unknown pose solver: {pose_solver!r}")
    if loader is None:
        if dataset is None:
            dataset = MultiSceneDataModule(cfg).test_dataset()
        loader = DataLoader(dataset, None, batch_size=1, num_workers=4,
                            drop_last=False)
    device = resolve_device(device)
    if device.type == "cuda":
        configure_card()
    model = model.to(device).eval()
    profiler = build_profiler(profiler_name)
    pose_fn = functools.partial(estimate_pose_batch,
                                thr_px=cfg.trainer.ransac_pixel_thr)
    metrics = {"identifiers": [], "epi_errs": [], "R_errs": [], "t_errs": [],
               "inliers": []}
    n = 0
    dumps = []
    batches = iter(loader)
    while True:
        with profiler.profile("Data loading"):
            batch = next(batches, None)
        if batch is None:
            break
        with profiler.profile("Model Matching"):
            with torch.inference_mode():
                fm = model(_model_batch(batch, device)).final_matches
            out_np = {k: getattr(fm, k).cpu().numpy()
                      for k in ("b_ids", "mkpts0", "mkpts1", "mconf",
                                "valid")}
        with profiler.profile("RANSAC"):
            if pose_solver == "device":
                _device_pose_metrics(out_np, batch, cfg, metrics, pose_fn,
                                     device)
            else:
                evaluate_batch_outputs(out_np, batch, cfg, metrics)
        if dump_dir is not None:
            dumps.append(out_np)
        if on_batch is not None:
            on_batch(n, batch, out_np, metrics)
        n += batch["K0"].shape[0]
        if max_pairs is not None and n >= max_pairs:
            break

    metrics = M.gather_metrics(metrics)
    if not metrics["identifiers"]:
        return {}
    results = M.aggregate_metrics(metrics, epi_err_thr=cfg.trainer.epi_err_thr)
    if dump_dir is not None:
        os.makedirs(dump_dir, exist_ok=True)
        np.save(os.path.join(dump_dir, "pred_eval.npy"),
                np.asarray(dumps, dtype=object), allow_pickle=True)
    summary = profiler.summary()
    if summary:
        print(summary)
    return results


def main(argv=None) -> Dict:
    """The evaluation command: build ``--model`` with ``--data``'s test
    split, load ``--ckpt`` (else seeded random weights), run ``run_eval``
    and print its results as JSON (also returned)."""
    p = argparse.ArgumentParser(
        description="CasMTR pose evaluation on a test split, in PyTorch")
    p.add_argument("--model", default="outdoor_casmtr_4c")
    p.add_argument("--data", default="megadepth_test_1500")
    p.add_argument("--ckpt", default=None,
                   help="a reference .ckpt/.pth or a port checkpoint "
                        "directory (train.checkpoints."
                        "load_checkpoint_variables)")
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--profiler", default=None,
                   help="'inference': seconds per region (loading, "
                        "matching, pose)")
    p.add_argument("--dump-dir", default=None)
    p.add_argument("--thr", type=float, default=None,
                   help="override the coarse matching threshold")
    p.add_argument("--img-size", type=int, default=None,
                   help="override the test image resize")
    p.add_argument("--overrides-json", default=None,
                   help="inline JSON config overrides (applied last)")
    p.add_argument("--pose-solver", default="cv2",
                   choices=("cv2", "device"),
                   help="cv2 = the reference protocol (per-pair essential-"
                        "matrix RANSAC and recoverPose on the host, "
                        "sfm/essential.py; no OpenCV); device = batched "
                        "essential-matrix RANSAC on the card (sfm/pose.py)")
    p.add_argument("--device", default=None,
                   help="where the model runs (default: the card, 'cuda'; "
                        "'cpu' for the CPU)")
    args = p.parse_args(argv)

    overrides = {}
    if args.thr is not None:
        overrides.setdefault("loftr", {}).setdefault(
            "match_coarse", {})["thr"] = args.thr
    if args.img_size is not None:
        overrides["dataset"] = {"mgdpt_img_resize": args.img_size}
    cfg = build_config(args.model, args.data, overrides or None)
    if args.overrides_json:
        cfg = cfg_override(cfg, json.loads(args.overrides_json))
    model = build_model(cfg.loftr)
    init_random_(model, torch.Generator().manual_seed(0))
    if args.ckpt:
        from casmtr_tpu_torch.train.checkpoints import \
            load_checkpoint_variables
        load_checkpoint_variables(args.ckpt, model)
    results = run_eval(cfg, model, max_pairs=args.max_pairs,
                       profiler_name=args.profiler, dump_dir=args.dump_dir,
                       pose_solver=args.pose_solver, device=args.device)
    print(json.dumps({k: float(v) for k, v in results.items()}, indent=2))
    return results


if __name__ == "__main__":
    main()
