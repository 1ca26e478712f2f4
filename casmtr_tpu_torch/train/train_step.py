"""The training step: supervision -> forward -> loss -> backward -> update
(counterpart of casmtr_tpu/train/train_step.py).

The JAX step is a pure function of its state; here the state holds the
model, whose parameters and BatchNorm running statistics the step updates in
place.  A step whose loss or gradient norm is not finite changes nothing but
``TrainState.step``: parameters, optimizer state (its update count included)
and BatchNorm statistics keep their last good values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from casmtr_tpu_torch.config import Config
from casmtr_tpu_torch.models.loftr import level_mask
from casmtr_tpu_torch.serving import resolve_device
from casmtr_tpu_torch.train import supervision as spv
from casmtr_tpu_torch.train.loss import casmtr_loss
from casmtr_tpu_torch.train.optim import (AdamW, OptState, build_optimizer,
                                          ema_beta_at, ema_update,
                                          global_norm)


@dataclass
class TrainState:
    step: int                      # steps taken, skipped ones included
    model: nn.Module               # parameters and BatchNorm statistics
    opt_state: OptState
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def _set_precision(dev: torch.device) -> None:
    """Full float32 on the card: the JAX package trains in float32, so TF32
    is turned off for matrix products and cuDNN convolutions.  cuDNN's
    autotuner is turned on: every step has the same shapes, and its
    heuristic once chose a 300 ms FFT algorithm for an FPN conv (see
    serving.Matcher).  All three are process-wide PyTorch flags."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True


def init_train_state(model: nn.Module, cfg: Config, steps_per_epoch: int,
                     base_lr: float, frozen_label_fn=None, device=None
                     ) -> Tuple[TrainState, AdamW]:
    """Move ``model`` (already initialized: random or loaded weights) to the
    device and build the optimizer and its state.  ``device`` None means the
    card, which raises without CUDA; pass "cpu" to train on the CPU."""
    dev = resolve_device(device)
    model.to(dev)
    tx = build_optimizer(cfg.trainer, base_lr, steps_per_epoch,
                         frozen_label_fn=frozen_label_fn)
    params = dict(model.named_parameters())
    ema = ({n: p.detach().clone() for n, p in params.items()}
           if cfg.trainer.ema else None)
    return TrainState(0, model, tx.init(params), ema), tx


def _to_device(batch: Dict, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(dev)
            for k, v in batch.items()}


def make_train_step(model: nn.Module, cfg: Config, tx: AdamW, device=None
                    ) -> Callable:
    """Returns step_fn(state, batch) -> (state, scalars), scalars being the
    0-dim tensors loss, loss_8c, loss_4c, loss_f, valid_n_4c and grad_norm.

    ``batch`` holds image0/image1 [B, H, W, 3], depth0/depth1 [B, H, W],
    K0/K1 [B, 3, 3], T_0to1/T_1to0 [B, 4, 4] and optionally mask0/mask1 and
    scale0/scale1, as tensors or numpy arrays.  ``device`` None means the
    card, which raises without CUDA; pass "cpu" to train on the CPU."""
    dev = resolve_device(device)
    _set_precision(dev)
    lcfg = cfg.loftr

    def loss_fn(batch, gt):
        out = model(batch)
        expec_gt = None
        if out.fine is not None:
            last = (list(out.cascades.values())[-1] if out.cascades
                    else out.coarse)
            expec_gt = spv.fine_expec_gt(gt, last.matches, batch, lcfg)
        c_weight = None
        if "mask0" in batch:
            m0, _ = level_mask(batch["mask0"], *out.coarse.hw0)
            m1, _ = level_mask(batch["mask1"], *out.coarse.hw1)
            c_weight = m0[:, :, None] * m1[:, None, :]
        loss, scalars = casmtr_loss(out, gt, expec_gt, lcfg,
                                    c_weight=c_weight)
        for lvl, stage in out.cascades.items():
            scalars[f"valid_n_{lvl}"] = stage.matches.valid.sum()
        return loss, scalars

    def step_fn(state: TrainState, batch: Dict):
        batch = _to_device(batch, dev)
        gt = spv.compute_supervision(batch, lcfg)
        if lcfg.cascade:
            for level in lcfg.cascade_levels:
                batch[f"gt_idx_{level}c"] = gt[f"gt_idx_{level}c"]
                batch[f"gt_mask_{level}c"] = gt[f"gt_mask_{level}c"]
        params = dict(model.named_parameters())
        # the forward moves the BatchNorm statistics; a skipped step restores
        stats = [b.clone() for b in model.buffers()]
        model.train()
        model.zero_grad(set_to_none=True)
        loss, scalars = loss_fn(batch, gt)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        gnorm = global_norm(grads.values())
        if bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
            tx.update(params, grads, state.opt_state)
            if state.ema_params is not None:
                ema_update(state.ema_params, params,
                           ema_beta_at(state.step, cfg.trainer))
        else:
            with torch.no_grad():
                for b, s in zip(model.buffers(), stats):
                    b.copy_(s)
        scalars = {k: v.detach() for k, v in scalars.items()}
        scalars["grad_norm"] = gnorm
        state.step += 1
        return state, scalars

    return step_fn
