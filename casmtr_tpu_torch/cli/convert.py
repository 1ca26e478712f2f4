"""Convert a reference checkpoint into a port checkpoint directory
(counterpart of casmtr_tpu/cli/convert.py), with the configuration it was
converted under, so that a deployment converts once:

    python -m casmtr_tpu_torch.cli.convert released.ckpt out_dir \\
        --model outdoor_casmtr_4c [--overrides-json '{...}'] [--strict]

``out_dir`` then holds step 0 (``train.checkpoints.CheckpointManager``, the
model's parameters and BatchNorm statistics) and ``config.json``
(``config.dump``); ``serving.Matcher(model, ckpt=out_dir)`` serves it.  It
runs on the CPU and needs no card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a reference .ckpt/.pth to a port checkpoint")
    p.add_argument("ckpt", help="reference .ckpt/.pth path")
    p.add_argument("out", help="output checkpoint directory")
    p.add_argument("--model", default="outdoor_casmtr_4c")
    p.add_argument("--overrides-json", default=None,
                   help="inline JSON config overrides (must match the "
                        "checkpoint's architecture)")
    p.add_argument("--strict", action="store_true",
                   help="fail on any key of the model the file lacks")
    args = p.parse_args(argv)

    from casmtr_tpu_torch.config import dump, override
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.checkpoints import CheckpointManager
    from casmtr_tpu_torch.utils.convert import (convert_state_dict,
                                                load_torch_checkpoint)
    from casmtr_tpu_torch.weights import init_random_

    cfg = build_config(args.model)
    if args.overrides_json:
        cfg = override(cfg, json.loads(args.overrides_json))
    model = build_model(cfg.loftr)
    # keys the file lacks (without --strict) keep a seeded init
    init_random_(model, torch.Generator().manual_seed(0))
    report = convert_state_dict(load_torch_checkpoint(args.ckpt), model,
                                strict=args.strict)
    print(f"converted: {len(report['missing'])} missing, "
          f"{len(report['unused'])} unused")
    for k in report["missing"][:10]:
        print(f"  missing: {k}")
    for k in report["unused"][:10]:
        print(f"  unused:  {k}")
    # one step: no '_last' sibling holding a second copy
    CheckpointManager(args.out, max_to_keep=1, keep_last=False).save(
        0, {"state_dict": model.state_dict(), "step": 0})
    dump(cfg, os.path.join(args.out, "config.json"))
    print(f"wrote the port checkpoint and config.json to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
