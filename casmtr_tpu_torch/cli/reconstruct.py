"""Sequence reconstruction (counterpart of casmtr_tpu/cli/reconstruct.py):
images -> matches -> tracks -> poses -> bundle adjustment.

Drives ``sfm/pipeline.reconstruct_sequence`` over a directory of frames
with shared pinhole intrinsics and writes a JSON report (poses, match and
track counts, the final BA cost), optionally a PLY point cloud:

    python -m casmtr_tpu_torch.cli.reconstruct /path/to/frames \\
        --fx 400 --fy 400 --cx 320 --cy 240 \\
        --resize 640 --out recon.json --ply recon.ply

The model runs on the card (``--device cpu`` for the CPU), with seeded
random weights unless ``--ckpt`` names a reference .ckpt/.pth or a port
checkpoint directory.  ``--pose-solver cv2`` (the default, as in the JAX
command) poses each pair by the reference protocol on the host
(``sfm/essential.py``: the port's own essential-matrix RANSAC and
``recoverPose``, no OpenCV); ``device`` by the batched RANSAC of
``sfm/pose.py`` on the card.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def write_ply(path: str, points: np.ndarray):
    """Minimal ASCII PLY writer for the BA point cloud."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(points)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for x, y, z in np.asarray(points, np.float64):
            f.write(f"{x:.6f} {y:.6f} {z:.6f}\n")


def main(argv=None):
    """The reconstruction command; returns the report it writes."""
    p = argparse.ArgumentParser(
        description="CasMTR SfM reconstruction, in PyTorch")
    p.add_argument("image_dir", help="directory of sequential frames "
                                     "(sorted by filename)")
    p.add_argument("--model", default="outdoor_casmtr_4c")
    p.add_argument("--ckpt", default=None,
                   help="a reference .ckpt/.pth or a port checkpoint "
                        "directory")
    p.add_argument("--resize", type=int, default=640)
    p.add_argument("--thr", type=float, default=0.2,
                   help="match confidence threshold")
    p.add_argument("--fx", type=float, required=True)
    p.add_argument("--fy", type=float, required=True)
    p.add_argument("--cx", type=float, required=True)
    p.add_argument("--cy", type=float, required=True)
    p.add_argument("--min-matches", type=int, default=100,
                   help="keyframe promotion threshold")
    p.add_argument("--max-gap", type=int, default=8)
    p.add_argument("--overlaps", type=int, nargs="+", default=[1, 2])
    p.add_argument("--ba-iters", type=int, default=20)
    p.add_argument("--huber", type=float, default=3.0,
                   help="Huber delta in px (<=0 for plain least squares)")
    p.add_argument("--keyframes", type=int, nargs="+", default=None,
                   help="explicit keyframe indices (skips adaptive "
                        "selection)")
    p.add_argument("--pose-solver", default="cv2",
                   choices=("cv2", "device"),
                   help="cv2 = per-pair host RANSAC (sfm/essential.py, no "
                        "OpenCV); device = batched essential-matrix RANSAC "
                        "on the card (sfm/pose.py)")
    p.add_argument("--pgo", action="store_true",
                   help="refine the chained init with pose-graph "
                        "optimization over all matched pairs before BA "
                        "(sfm/pose_graph.py)")
    p.add_argument("--out", default="recon.json")
    p.add_argument("--ply", default=None)
    p.add_argument("--overrides-json", default=None,
                   help="inline JSON config overrides (applied last)")
    p.add_argument("--device", default=None,
                   help="where the model and the SfM device work run "
                        "(default: the card, 'cuda'; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    exts = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")
    paths = sorted(
        os.path.join(args.image_dir, f) for f in os.listdir(args.image_dir)
        if f.lower().endswith(exts))
    if len(paths) < 3:
        raise SystemExit(f"need >= 3 frames, found {len(paths)}")
    print(f"{len(paths)} frames")

    import torch

    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.serving import resolve_device
    from casmtr_tpu_torch.sfm import pipeline as pl
    from casmtr_tpu_torch.sfm import reconstruct as Rc
    from casmtr_tpu_torch.sfm.geometry import rodrigues
    from casmtr_tpu_torch.weights import init_random_

    device = resolve_device(args.device)
    cfg = build_config(args.model)
    if args.overrides_json:
        cfg = override(cfg, json.loads(args.overrides_json))
    model = build_model(cfg.loftr)
    init_random_(model, torch.Generator().manual_seed(0))
    if args.ckpt:
        from casmtr_tpu_torch.train.checkpoints import \
            load_checkpoint_variables
        load_checkpoint_variables(args.ckpt, model)

    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]])
    match_fn = pl.model_match_fn(cfg, model, paths, resize=args.resize,
                                 thr=args.thr, device=device)
    res = pl.reconstruct_sequence(
        match_fn, len(paths), K, keyframes=args.keyframes,
        min_matches=args.min_matches, max_gap=args.max_gap,
        overlaps=tuple(args.overlaps), ba_iters=args.ba_iters,
        huber_delta=args.huber if args.huber > 0 else None,
        pose_solver=args.pose_solver, pgo=args.pgo, device=device)

    centers = Rc.camera_centers(res.problem)
    n_obs = int(res.problem.obs_valid.sum())
    rms = float(np.sqrt(res.cost / max(n_obs, 1) / 2))
    Rs = rodrigues(res.problem.cam_rvec).cpu().numpy()
    tvecs = res.problem.cam_tvec.cpu().numpy()
    report = {
        "n_frames": len(paths),
        "keyframes": [int(k) for k in res.keyframes],
        "n_pairs": len(res.matches),
        "n_matches": {f"{i}-{j}": int(len(m[0]))
                      for (i, j), m in sorted(res.matches.items())},
        "n_tracks": len(res.tracks),
        "n_obs": n_obs,
        "ba_cost": res.cost,
        "rms_reproj_px_rho": rms,
        "poses": [{
            "frame": int(f),
            "R": Rs[a].tolist(),
            "t": tvecs[a].tolist(),
            "center": centers[a].tolist(),
        } for a, f in enumerate(res.keyframes)],
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"keyframes={report['keyframes']} tracks={report['n_tracks']} "
          f"obs={n_obs} rms(rho)={rms:.2f}px")
    print(f"wrote {args.out}")
    if args.ply:
        points = res.problem.points.cpu().numpy()
        write_ply(args.ply, points)
        print(f"wrote {args.ply} ({len(points)} points)")
    return report


if __name__ == "__main__":
    main()
