"""Checkpoints of the port (counterpart of casmtr_tpu/train/checkpoints.py):
a manager that keeps the best steps by a metric and always the newest, the
non-strict merge a later training stage resumes with, and the loader that
takes a reference ``.ckpt``/``.pth`` or a port checkpoint directory.

A port checkpoint is one ``torch.save`` file per step holding only plain
dicts of CPU tensors, ints and strings (``checkpoint_state``): the model's
``state_dict`` (parameters and BatchNorm statistics), the ``OptState``
fields, the step and the EMA parameters.  ``torch.load(weights_only=True)``
reads it on a machine with or without a card.  The JAX package's orbax
directories are not read here: the port imports no JAX, and JAX-trained
weights reach it through ``weights.load_jax_variables``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.nn as nn

_STEP_FILE = re.compile(r"^(\d+)\.pt$")
_METRICS = "metrics.json"


def _to_cpu(tree: Any) -> Any:
    """``tree`` (dicts of tensors, ints, floats and strings) with every
    tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {str(k): _to_cpu(v) for k, v in tree.items()}
    return tree


def _replace_atomically(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


class _StepDir:
    """One directory of step files ``<step>.pt`` with their metrics in
    ``metrics.json``, keeping at most ``max_to_keep`` steps: the best by
    ``best_fn`` (a step without the metric counts as -1.0; ties keep the
    newer step), or the newest when ``best_fn`` is None."""

    def __init__(self, directory: str, max_to_keep: Optional[int],
                 best_fn=None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.best_fn = best_fn

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def metrics(self) -> Dict[int, Dict]:
        p = os.path.join(self.directory, _METRICS)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def _ranked(self, metrics: Optional[Dict[int, Dict]] = None
                ) -> List[int]:
        """Steps from worst to best."""
        steps = self.steps()
        if self.best_fn is None:
            return steps
        metrics = self.metrics() if metrics is None else metrics
        return sorted(steps, key=lambda s: (self.best_fn(metrics.get(s, {})),
                                            s))

    def save(self, step: int, state: Dict, metrics: Dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        _replace_atomically(self.path(step),
                            lambda tmp: torch.save(state, tmp))
        kept = self.metrics()
        kept[int(step)] = dict(metrics)
        ranked = self._ranked(kept)
        drop = ranked[:-self.max_to_keep] if self.max_to_keep else []
        for s in drop:
            os.remove(self.path(s))
            kept.pop(s, None)

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({str(k): v for k, v in sorted(kept.items())}, f)
        _replace_atomically(os.path.join(self.directory, _METRICS), write)

    def best(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None


class CheckpointManager:
    """Keep-best by metric plus always-keep-newest: the best
    ``max_to_keep`` steps by ``metric_name`` (higher is better) in
    ``directory``, and with ``keep_last`` the newest step in the sibling
    ``<directory>_last`` (PyTorch Lightning's ``save_top_k`` with
    ``save_last``, as the JAX package's orbax managers).  ``restore()``
    takes the newest step across both."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 metric_name: str = "auc@10", keep_last: bool = True):
        directory = os.path.abspath(directory).rstrip("/")
        self.best_dir = _StepDir(directory, max_to_keep,
                                 lambda m: m.get(metric_name, -1.0))
        self.last_dir = (_StepDir(directory + "_last", 1) if keep_last
                         else None)

    def _dirs(self):
        return [d for d in (self.best_dir, self.last_dir) if d is not None]

    def save(self, step: int, state: Dict, metrics: Optional[Dict] = None
             ) -> None:
        """Write ``state`` (dicts of tensors, ints, floats and strings; the
        tensors are copied to the CPU) as step ``step``: each file is
        written under a temporary name and then renamed into place."""
        state = _to_cpu(state)
        for d in self._dirs():
            d.save(step, state, metrics or {})

    def restore(self, step: Optional[int] = None) -> Optional[Dict]:
        """The saved state of ``step`` (the newest across both directories
        if None) on the CPU, or None if there is none."""
        found = [(s, i, d) for i, d in enumerate(self._dirs())
                 for s in d.steps() if step is None or s == step]
        if not found:
            return None
        s, _, d = max(found, key=lambda f: (f[0], f[1]))
        return torch.load(d.path(s), map_location="cpu", weights_only=True)

    def all_steps(self) -> List[int]:
        return sorted({s for d in self._dirs() for s in d.steps()})

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        return self.best_dir.best()


def checkpoint_state(state) -> Dict:
    """What a checkpoint of the training state ``state``
    (``train_step.TrainState``) holds: the model's ``state_dict``, the
    optimizer state's fields, the step and (when kept) the EMA parameters."""
    opt = state.opt_state
    out = {"state_dict": state.model.state_dict(),
           "opt_state": {"mu": opt.mu, "nu": opt.nu, "count": int(opt.count),
                         "schedule_count": int(opt.schedule_count),
                         "labels": dict(opt.labels)},
           "step": int(state.step)}
    if state.ema_params is not None:
        out["ema_params"] = state.ema_params
    return out


def load_into_state(restored: Mapping[str, torch.Tensor], module: nn.Module
                    ) -> Dict[str, List[str]]:
    """Non-strict merge of a saved state dict into a freshly initialized
    ``module``, in place: each parameter or buffer that ``restored`` holds
    under the same key and with the same shape is copied from it, and the
    rest keep their fresh values.  A later training stage resumes an
    earlier stage's checkpoint this way (its new modules stay fresh), and
    the PMT-refine model takes a ``quadtree_baseline`` trunk (its ladder
    and ``cas_`` heads stay fresh).  Returns the sorted keys ``taken`` from
    ``restored``, left ``fresh``, and ``unused`` keys of ``restored``."""
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


def _is_orbax_dir(path: str) -> bool:
    """A directory of orbax step directories (numeric subdirectories)."""
    return any(name.isdigit() and os.path.isdir(os.path.join(path, name))
               for d in (path, path.rstrip("/") + "_last")
               if os.path.isdir(d) for name in os.listdir(d))


def load_checkpoint_variables(path: str, module: nn.Module
                              ) -> Dict[str, List[str]]:
    """Load model weights into ``module``, in place, from a reference
    ``.ckpt``/``.pth`` (strict: every key of the module, else KeyError) or
    from a port checkpoint directory (a non-strict merge of the newest
    step's parameters AND buffers: without the BatchNorm statistics the
    model would evaluate with fresh ones).  Returns the conversion's report
    (missing, unused) or the merge's (taken, fresh, unused)."""
    if path.endswith((".ckpt", ".pth")):
        from casmtr_tpu_torch.utils.convert import (convert_state_dict,
                                                    load_torch_checkpoint)
        report = convert_state_dict(load_torch_checkpoint(path), module)
        print(f"converted torch checkpoint: {len(report['missing'])} "
              f"missing, {len(report['unused'])} unused keys")
        return report
    restored = CheckpointManager(path).restore()
    if restored is None:
        if os.path.isdir(path) and _is_orbax_dir(path):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package, which "
                "the port does not read: load its variables with "
                "casmtr_tpu_torch.weights.load_jax_variables")
        raise FileNotFoundError(f"no port checkpoint found in {path}")
    return load_into_state(restored["state_dict"], module)
