"""Single-pair matching (counterpart of casmtr_tpu/cli/match_pair.py): load
two images, run the matcher, print the number of matches.

    python -m casmtr_tpu_torch.cli.match_pair IMG0 IMG1 --ckpt CKPT

The JAX command also draws the matches into a figure (``--out``, through
matplotlib); the figure is not ported (ROADMAP queue A), so ``--out``
defaults to None here and giving it raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json

import torch

from casmtr_tpu_torch.config import override
from casmtr_tpu_torch.configs import build_config
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
    p.add_argument("--out", default=None,
                   help="the JAX command's match figure: not ported (it "
                        "needs matplotlib; ROADMAP queue A), so giving it "
                        "raises NotImplementedError")
    p.add_argument("--overrides-json", default=None,
                   help="inline JSON config overrides (e.g. to select a "
                        "post-process method)")
    p.add_argument("--nms", action="store_true",
                   help="maxpool NMS post-processing at the 1/4 level")
    p.add_argument("--device", default=None,
                   help="where the model runs (default: the card, 'cuda'; "
                        "'cpu' for the CPU)")
    args = p.parse_args(argv)
    if args.out is not None:
        raise NotImplementedError(
            "--out: the match figure is not ported (it needs matplotlib; "
            "see ROADMAP.md queue A, utils/plotting)")

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
    return mk0, mk1, mconf


if __name__ == "__main__":
    main()
