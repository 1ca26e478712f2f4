"""Checkpoint loading (counterpart of casmtr_tpu/train/checkpoints.py; only
its non-strict merge so far)."""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
import torch.nn as nn


def load_into_state(restored: Mapping[str, torch.Tensor], module: nn.Module
                    ) -> Dict[str, List[str]]:
    """Non-strict merge of a saved state dict into a freshly initialized
    ``module``, in place: each parameter or buffer that ``restored`` holds
    under the same key and with the same shape is copied from it, and the
    rest keep their fresh values.  This loads a trunk checkpoint (a
    ``quadtree_baseline`` model's state dict) into the PMT-refine model,
    whose ladder and ``cas_`` heads then stay fresh.  Returns the sorted
    keys ``taken`` from ``restored``, left ``fresh``, and ``unused`` keys of
    ``restored``."""
    own = module.state_dict()
    taken = sorted(k for k, v in restored.items()
                   if k in own and tuple(own[k].shape) == tuple(v.shape))
    with torch.no_grad():
        for k in taken:
            own[k].copy_(restored[k])
    done = set(taken)
    return {"taken": taken,
            "fresh": sorted(k for k in own if k not in done),
            "unused": sorted(k for k in restored if k not in done)}
