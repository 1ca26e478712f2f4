"""Reference checkpoints into the port (counterpart of
casmtr_tpu/utils/convert.py).

The JAX package renames each reference key into a flax path and changes
its layout.  The port's ``state_dict`` keys already are the reference's
module names (``weights.py``) and its modules keep the reference's layouts,
so a reference state dict loads by name:

* the ``matcher.`` prefix of the reference's Lightning checkpoints is
  stripped;
* every tensor must have the shape of the port's own: the port keeps the
  reference's layouts, down to the 1x1 convolutions that the JAX package
  realizes as flax ``Dense`` layers (the quadtree attention's
  ``q_proj``/``k_proj``/``v_proj`` and the refine model's
  ``proj4c``/``projf``: Conv2d weights [O, I, 1, 1] in both);
* parameters and buffers (BatchNorm running statistics) load alike.
  BatchNorm's ``num_batches_tracked`` counters load when the file holds
  them and are not missing when it does not (eval mode never reads them).

Reference keys without a port counterpart that are expected leftovers are
not reported as unused, as in the JAX function: ``num_batches_tracked``,
``relative_position_index`` (POLA's index table, which the port computes
and keeps out of its state dict) and ``.window`` buffers.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

PREFIX = "matcher."


def _leftover(key: str) -> bool:
    return (key.endswith("num_batches_tracked")
            or key.endswith("relative_position_index") or ".window" in key)


def _fit(key: str, value: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``value`` if it has the port's ``shape``, else ValueError."""
    if tuple(value.shape) != shape:
        raise ValueError(f"{key}: checkpoint tensor of shape "
                         f"{tuple(value.shape)} does not fit {shape}")
    return value


def convert_state_dict(torch_sd: Mapping[str, Any], module: nn.Module,
                       strict: bool = True) -> Dict[str, List[str]]:
    """Load a reference state dict (tensors or numpy arrays, with or without
    the ``matcher.`` prefix) into ``module``'s parameters and buffers, in
    place.  Returns ``{"missing": [...], "unused": [...]}``: the module's
    keys the file lacks and the file's keys the module lacks (expected
    leftovers left out of both).  A tensor of another shape raises
    ValueError; with ``strict`` anything missing raises KeyError.  Either
    error leaves the module as it was."""
    sd = {}
    for k, v in torch_sd.items():
        if k.startswith(PREFIX):
            k = k[len(PREFIX):]
        sd[k] = (v.detach().cpu() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.asarray(v)))
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not _leftover(k)]
    fitted = {k: _fit(k, sd[k], tuple(t.shape))
              for k, t in own.items() if k in sd}
    if strict and missing:
        raise KeyError(f"checkpoint lacks keys of the module: {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    with torch.no_grad():
        for k, v in fitted.items():
            own[k].copy_(v)
    unused = sorted(k for k in sd if k not in own and not _leftover(k))
    return {"missing": missing, "unused": unused}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference ``.ckpt`` (PyTorch Lightning: under
    ``"state_dict"``) or ``.pth`` (the dict itself), as CPU tensors.  A
    Lightning checkpoint pickles more than tensors (hyperparameters,
    callbacks), so it is read with ``weights_only=False``: load only files
    from a source you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
