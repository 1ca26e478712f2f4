"""Training entry point of the port (counterpart of casmtr_tpu/cli/train.py).
It holds the stage-aware resume for now; the command itself comes with the
data layer.

A run starts with ``train_step.init_train_state`` and saves
``train.checkpoints.checkpoint_state`` of its state through a
``CheckpointManager``; a later run (the same stage, or the next stage of a
staged recipe) builds its own fresh state and passes it with the restored
checkpoint to ``resume_state``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from casmtr_tpu_torch.config import Config
from casmtr_tpu_torch.train.checkpoints import load_into_state
from casmtr_tpu_torch.train.optim import (AdamW, OptState, build_lr_schedule,
                                          build_optimizer, new_stage_labels,
                                          scaled_lr, set_schedule_step)
from casmtr_tpu_torch.train.train_step import TrainState


def _fits(saved: Dict, fresh: OptState) -> bool:
    """Whether a saved optimizer state has exactly the fresh one's
    structure: the same parameter labels and the same moment names and
    shapes."""
    if saved.get("labels") != fresh.labels:
        return False
    return all(set(saved[k]) == set(getattr(fresh, k)) and all(
        tuple(saved[k][n].shape) == tuple(t.shape)
        for n, t in getattr(fresh, k).items()) for k in ("mu", "nu"))


def resume_state(cfg: Config, state: TrainState, restored: Dict,
                 base_lr: float, steps_per_epoch: int,
                 reset_lr: bool = False, resume_dir: Optional[str] = None,
                 frozen_label_fn=None, global_bs: Optional[int] = None
                 ) -> Tuple[TrainState, AdamW, Callable[[int], float]]:
    """Resume a run from ``restored`` (``CheckpointManager.restore()`` of a
    port checkpoint) into ``state``, a fresh state of the current
    configuration (``init_train_state``), as the JAX package's function:

    * parameters and buffers merge non-strictly (``load_into_state``):
      modules that a later stage adds keep their fresh init;
    * at stage > 1 every parameter whose name lacks ``8c`` and
      ``backbone`` goes to the ``new`` group, which re-warms over
      ``warmup_step_stages`` steps from the restored step (on EVERY
      stage > 1 (re)start, not only for the fresh modules);
    * without ``reset_lr`` the checkpointed run's trainer settings are
      kept: its ``config.json`` beside the checkpoint directory
      ``resume_dir``, the learning rate re-derived from it (through
      ``scaled_lr`` when ``global_bs`` is given);
    * the optimizer state is restored only when it fits exactly (the same
      labels and moment names and shapes: a same-stage resume of a run
      that itself resumed at that stage), and is fresh otherwise; the
      schedules continue from the restored step (``set_schedule_step``);
    * the EMA parameters are restored when the checkpoint holds them;
    * ``frozen_label_fn`` keeps a refine model's trunk out of the update.

    The model of ``state`` is updated in place.  Returns (state, the
    optimizer, the base learning-rate schedule)."""
    tcfg = cfg.trainer
    if not reset_lr and resume_dir:
        old_cfg_path = os.path.join(os.path.dirname(resume_dir.rstrip("/")),
                                    "config.json")
        if os.path.exists(old_cfg_path):
            from casmtr_tpu_torch.config import load as load_cfg
            tcfg = load_cfg(old_cfg_path).trainer
            if global_bs is not None:
                base_lr = scaled_lr(tcfg, global_bs,
                                    cfg.dataset.trainval_data_source)
            else:
                base_lr = base_lr * (tcfg.canonical_lr
                                     / cfg.trainer.canonical_lr
                                     ) * (cfg.trainer.canonical_bs
                                          / tcfg.canonical_bs)

    model = state.model
    load_into_state(restored.get("state_dict") or {}, model)
    rstep = int(restored.get("step", 0))
    params = dict(model.named_parameters())
    labels = (new_stage_labels(params)
              if cfg.loftr.training_stage > 1 else None)
    tx = build_optimizer(tcfg, base_lr, steps_per_epoch,
                         new_param_labels=labels, restore_step=rstep,
                         frozen_label_fn=frozen_label_fn)
    opt_state = tx.init(params)
    saved = restored.get("opt_state")
    if saved is not None and _fits(saved, opt_state):
        moments = {k: {n: saved[k][n].to(params[n].device, params[n].dtype)
                       for n in getattr(opt_state, k)} for k in ("mu", "nu")}
        opt_state = dataclasses.replace(opt_state, count=int(saved["count"]),
                                        **moments)
    opt_state = set_schedule_step(opt_state, rstep)
    ema = None
    if cfg.trainer.ema:
        ema = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, t in (restored.get("ema_params") or {}).items():
                if n in ema and tuple(ema[n].shape) == tuple(t.shape):
                    ema[n].copy_(t)
    schedule = build_lr_schedule(tcfg, base_lr, steps_per_epoch)
    return TrainState(rstep, model, opt_state, ema), tx, schedule
