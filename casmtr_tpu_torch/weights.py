"""Weights for the port: the JAX package's flax variables carried across, and
seeded random weights.

``load_jax_variables`` is the inverse of casmtr_tpu/utils/convert.py (the
port keeps its own copy of the name rules).  Flax module paths mirror the
reference's torch module names, so each flax leaf maps to one ``state_dict``
key:

* path segments ``foo_0`` -> ``foo.0``, ``dwconv_dwconv`` -> ``dwconv.dwconv``;
* Dense kernel [I, O] -> Linear weight [O, I]; a Dense that realizes a 1x1
  Conv2d -> [O, I, 1, 1];
* Conv kernel HWIO -> OIHW (depthwise [kh, kw, 1, C] -> [C, 1, kh, kw]);
* BatchNorm scale/bias + batch_stats mean/var -> weight/bias +
  running_mean/running_var; LayerNorm scale -> weight;
* QTAttB and Guided merge logits ``py_att_weight`` -> ``py_att.weight``
  (quadtree attention A has none); Embed ``embedding`` -> Embedding
  ``weight``; POLA's ``relative_position_bias_table`` and LKABlock's
  ``layer_scale_1``/``layer_scale_2`` keep their names (so LKABlock's
  ``mlp_fc1`` and ``VAN``'s ``proj_1`` become ``mlp_fc1`` and ``proj.1``,
  as the JAX package's rules map them).

``jax_variables`` is the inverse: it lays torch tensors (parameters,
running statistics, or gradients by parameter name) out as the nested
numpy dicts of a given flax variable tree, so the two packages compare
leaf by leaf.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF_MAP = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "embedding": "weight",
    "mean": "running_mean",
    "var": "running_var",
}
_IDX_RE = re.compile(r"_(\d+)(?=\.|$)")


def _segment_to_torch(seg: str) -> str:
    """'blocks_0_1' -> 'blocks.0.1'; 'dwconv_dwconv' -> 'dwconv.dwconv'."""
    if seg == "dwconv_dwconv":
        return "dwconv.dwconv"
    out = seg
    while True:
        new = _IDX_RE.sub(r".\1", out)
        if new == out:
            return new
        out = new


def flax_path_to_torch_key(path: Tuple[str, ...], leaf: str) -> str:
    """Map a flax module path + leaf name to the torch state_dict key."""
    segs = [_segment_to_torch(p) for p in path]
    if leaf == "py_att_weight":
        segs.append("py_att.weight")
    else:
        segs.append(_LEAF_MAP.get(leaf, leaf))
    return ".".join(segs)


def _to_torch_layout(value: np.ndarray, shape: Tuple[int, ...], leaf: str,
                     key: str) -> np.ndarray:
    v = np.asarray(value)
    if leaf == "kernel":
        if v.ndim == 4:                        # conv HWIO -> OIHW
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:                      # Dense [I, O] -> [O, I]
            v = v.T
            if len(shape) == 4:                # Dense realizing a 1x1 conv
                v = v[:, :, None, None]
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{key}: JAX leaf '{leaf}' of shape "
                         f"{np.shape(value)} does not fit {tuple(shape)}")
    return np.ascontiguousarray(v)


def load_jax_variables(module: nn.Module, variables: Mapping) -> None:
    """Fill ``module``'s parameters and buffers from the JAX package's
    variables ``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy
    arrays).  Strict: every parameter and buffer is filled and every JAX
    leaf is used, else KeyError.  BatchNorm's ``num_batches_tracked``
    counters have no JAX counterpart and are left as they are (eval mode
    never reads them)."""
    flat: Dict[str, Tuple[str, np.ndarray]] = {}

    def walk(tree: Mapping, path: Tuple[str, ...]) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (name,))
                continue
            key = flax_path_to_torch_key(path, name)
            if key in flat:
                raise KeyError(f"two JAX leaves map to {key}")
            flat[key] = (name, value)

    for col, tree in variables.items():
        if col not in ("params", "batch_stats"):
            raise KeyError(f"unexpected JAX variable collection {col!r}")
        walk(tree, ())
    sd = module.state_dict()
    wanted = {k for k in sd if not k.endswith("num_batches_tracked")}
    missing = sorted(wanted - flat.keys())
    unused = sorted(flat.keys() - wanted)
    if missing or unused:
        raise KeyError(f"JAX variables do not match the module: missing "
                       f"{missing[:10]}, unused {unused[:10]}")
    with torch.no_grad():
        for key in wanted:
            leaf, value = flat[key]
            arr = _to_torch_layout(value, tuple(sd[key].shape), leaf, key)
            sd[key].copy_(torch.from_numpy(arr))


def _from_torch_layout(value: np.ndarray, like: np.ndarray, leaf: str,
                       key: str) -> np.ndarray:
    """Inverse of ``_to_torch_layout`` for a leaf shaped like ``like``."""
    v = np.asarray(value)
    if leaf == "kernel":
        if v.ndim == 4 and np.ndim(like) == 2:   # 1x1 conv as a Dense
            v = v[:, :, 0, 0].T
        elif v.ndim == 4:                        # conv OIHW -> HWIO
            v = v.transpose(2, 3, 1, 0)
        elif v.ndim == 2:                        # Linear [O, I] -> [I, O]
            v = v.T
    if v.shape != np.shape(like):
        raise ValueError(f"{key}: torch tensor of shape {np.shape(value)} "
                         f"does not fit JAX leaf '{leaf}' {np.shape(like)}")
    return np.ascontiguousarray(v)


def jax_variables(tensors: Mapping[str, torch.Tensor], like: Mapping
                  ) -> Dict:
    """Torch tensors by ``state_dict`` key (a module's ``state_dict()``, or
    its gradients by parameter name) laid out as the flax tree ``like``
    (for instance ``{"params": ..., "batch_stats": ...}``): nested dicts of
    float32 numpy arrays with the same paths and shapes.  Strict: a leaf of
    ``like`` with no tensor raises KeyError."""

    def walk(tree: Mapping, path: Tuple[str, ...]) -> Dict:
        out = {}
        for name, value in tree.items():
            if isinstance(value, Mapping):
                out[name] = walk(value, path + (name,))
                continue
            key = flax_path_to_torch_key(path, name)
            if key not in tensors:
                raise KeyError(f"no torch tensor for JAX leaf {key}")
            t = tensors[key].detach().to("cpu", torch.float32).numpy()
            out[name] = _from_torch_layout(t, value, name, key)
        return out

    return {col: walk(tree, ()) for col, tree in like.items()}


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: Linear/Conv weights N(0, 1/fan_in), biases 0,
    norm scales 1, BatchNorm running statistics (0, 1), quadtree merge
    logits and relative-PE embeddings N(0, 1), POLA bias tables N(0,
    0.02^2) (the JAX package's initial scale), LKA layer scales 1e-2 (the
    JAX package's initial value).  Raises if a parameter is of a kind not
    listed."""
    from casmtr_tpu_torch.models.cascade_attention import LKABlock
    from casmtr_tpu_torch.models.pola import NeighborWindowAttention
    from casmtr_tpu_torch.models.transformer import QTAttB

    def randn(t: torch.Tensor, std: float) -> torch.Tensor:
        return (torch.randn(t.shape, generator=generator) * std).to(t)

    done = set()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(randn(m.weight, m.weight[0].numel() ** -0.5))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
            elif isinstance(m, (QTAttB, nn.Embedding)):
                m.weight.copy_(randn(m.weight, 1.0))
            elif isinstance(m, NeighborWindowAttention):
                t = m.relative_position_bias_table
                t.copy_(randn(t, 0.02))
            elif isinstance(m, LKABlock):
                m.layer_scale_1.fill_(1e-2)
                m.layer_scale_2.fill_(1e-2)
            else:
                continue
            done.update(id(p) for p in m.parameters(recurse=False))
    left = [n for n, p in module.named_parameters() if id(p) not in done]
    if left:
        raise TypeError(f"init_random_: no rule for parameters {left[:5]}")
