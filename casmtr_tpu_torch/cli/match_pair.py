"""Single-pair matching (counterpart of casmtr_tpu/cli/match_pair.py): load
two images, run the matcher, print the number of matches and draw them
into a figure.

    python -m casmtr_tpu_torch.cli.match_pair IMG0 IMG1 --ckpt CKPT \
        --out result.png

The figure is ``utils/plotting.make_matching_figure``'s raster (green
lines, alpha ``clip(mconf, 0.2, 1)``, the text "CasMTR-TPU: N matches"),
written as a PNG whatever the extension of ``--out``; the JAX command's is
a matplotlib figure.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from casmtr_tpu_torch.config import override
from casmtr_tpu_torch.configs import build_config
from casmtr_tpu_torch.data import codecs
from casmtr_tpu_torch.data.io import load_im_padding
from casmtr_tpu_torch.models import build_model
from casmtr_tpu_torch.serving import configure_card, resolve_device
from casmtr_tpu_torch.weights import init_random_


def make_matcher(cfg, model: torch.nn.Module, resize: int = 1024,
                 thr: float = 0.2, device=None):
    """A reusable ``fn(path0, path1) -> (mkpts0, mkpts1, mconf)`` over
    ``model`` (a port model of ``cfg.loftr``, moved to ``device`` and put
    in eval mode; None means the card): both images resized so the shorter
    side is ``resize`` (df 32), padded to a common canvas with masks."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        configure_card()
    model = model.to(dev).eval()

    def fn(path0, path1):
        img0, img1, mask0, mask1, scale0, scale1 = load_im_padding(
            path0, path1, resize=resize, df=32)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in (
            ("image0", img0), ("image1", img1), ("mask0", mask0),
            ("mask1", mask1), ("scale0", scale0[None]),
            ("scale1", scale1[None]))}
        with torch.inference_mode():
            fm = model(batch).final_matches
        out = {k: getattr(fm, k).cpu().numpy()
               for k in ("mkpts0", "mkpts1", "mconf", "valid")}
        keep = out["valid"] & (out["mconf"] > thr)
        return out["mkpts0"][keep], out["mkpts1"][keep], out["mconf"][keep]

    return fn


def match_pair(cfg, model: torch.nn.Module, path0, path1, resize: int = 1024,
               thr: float = 0.2, device=None):
    """Returns (mkpts0, mkpts1, mconf) in ORIGINAL image pixel coords."""
    return make_matcher(cfg, model, resize=resize, thr=thr,
                        device=device)(path0, path1)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="CasMTR single-pair matching, in PyTorch")
    p.add_argument("img0")
    p.add_argument("img1")
    p.add_argument("--model", default="outdoor_casmtr_4c")
    p.add_argument("--ckpt", default=None,
                   help="a reference .ckpt/.pth or a port checkpoint "
                        "directory")
    p.add_argument("--resize", type=int, default=1024)
    p.add_argument("--thr", type=float, default=0.2)
    p.add_argument("--out", default="result.png",
                   help="where the match figure goes (a PNG)")
    p.add_argument("--overrides-json", default=None,
                   help="inline JSON config overrides (e.g. to select a "
                        "post-process method)")
    p.add_argument("--nms", action="store_true",
                   help="maxpool NMS post-processing at the 1/4 level")
    p.add_argument("--device", default=None,
                   help="where the model runs (default: the card, 'cuda'; "
                        "'cpu' for the CPU)")
    args = p.parse_args(argv)

    cfg = build_config(args.model)
    if args.overrides_json:
        cfg = override(cfg, json.loads(args.overrides_json))
    if args.nms:
        cfg = override(cfg, {"loftr": {"coarse2": {"post_config": {
            "method": "maxpool_nms", "window_size": 5}}}})
    model = build_model(cfg.loftr)
    init_random_(model, torch.Generator().manual_seed(0))
    if args.ckpt:
        from casmtr_tpu_torch.train.checkpoints import \
            load_checkpoint_variables
        load_checkpoint_variables(args.ckpt, model)
    mk0, mk1, mconf = match_pair(cfg, model, args.img0, args.img1,
                                 resize=args.resize, thr=args.thr,
                                 device=args.device)
    print(f"{len(mk0)} matches")

    from casmtr_tpu_torch.utils.plotting import make_matching_figure
    im0 = codecs.imread(args.img0) / 255.0
    im1 = codecs.imread(args.img1) / 255.0
    color = np.zeros((len(mk0), 4))
    color[:, 1] = 1.0
    color[:, 3] = np.clip(mconf, 0.2, 1.0) if len(mconf) else 1.0
    make_matching_figure(im0, im1, mk0, mk1, color,
                         text=[f"CasMTR-TPU: {len(mk0)} matches"],
                         path=args.out)
    print(f"wrote {args.out}")
    return mk0, mk1, mconf


if __name__ == "__main__":
    main()
