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

from casmtr_tpu_torch.config import Config, LoftrConfig
from casmtr_tpu_torch.models.casmtr import STAGES, run_stages
from casmtr_tpu_torch.models.loftr import level_mask
from casmtr_tpu_torch.parallel import mesh
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
    """The precision of the step follows the policy (models/casmtr.py): on
    the card the backbone computes in bfloat16 and kernels A, A′, C and
    their backward kernels take bf16 q/k/v, while the coarse, cascade and
    fine stacks, the matching heads and the loss compute in float32; with
    ``CASMTR_BACKBONE_BF16=0 CASMTR_TRANSFORMER_BF16=0`` the whole step is
    float32; on the CPU it is float32 unless a variable forces bf16.  So on
    the card TF32 is turned off for matrix products and cuDNN convolutions
    (float32 work is full float32), and bf16 products keep float32 sums.
    cuDNN's autotuner is turned on: every step has the same shapes, and its
    heuristic once chose a 300 ms FFT algorithm for an FPN conv (see
    serving.Matcher).  All four are process-wide PyTorch flags."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False
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


def prepare_batch(batch: Dict, lcfg: LoftrConfig, dev: torch.device
                  ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``batch`` on ``dev`` with the ground truth of each value of
    ``cascade_levels`` (gt_idx_{value}c, gt_mask_{value}c) added, as the
    JAX step adds it (a cascade stage reads its own name's, so with other
    values than (4,) or (4, 2) a stage may find none), and the
    supervision."""
    batch = _to_device(batch, dev)
    gt = spv.compute_supervision(batch, lcfg)
    if lcfg.cascade:
        for level in lcfg.cascade_levels:
            batch[f"gt_idx_{level}c"] = gt[f"gt_idx_{level}c"]
            batch[f"gt_mask_{level}c"] = gt[f"gt_mask_{level}c"]
    return batch, gt


def detector_uniforms(lcfg: LoftrConfig, batch: Dict[str, torch.Tensor],
                      seed: int, step: int) -> Dict[str, torch.Tensor]:
    """The gumbel detector's draws of one step: for each cascade stage
    (``models.casmtr.STAGES``, by position: 1/4, then 1/2) whose
    ``detector_mode`` is gumbel, ``sample_uniform_{name}`` [B, cells, g*g]
    at the stage's grid, uniform in [1e-9, 1) (the JAX package's range),
    from a generator on the batch's device seeded from (``seed``, ``step``,
    the stage's grid factor).  The JAX package draws from its own PRNG, so
    the two streams differ; the model takes the draw from the batch, so a
    test can feed both the same.  Inside ``parallel.mesh.global_batch()``
    the draw is the global batch's (``world`` times the rows) and this rank
    keeps its rows of it."""
    if not lcfg.cascade:
        return {}
    B, H, W = batch["image0"].shape[:3]
    dev = batch["image0"].device
    world = 1 if mesh.batch_group() is None else mesh.world_size()
    out = {}
    for (level, name), scfg in zip(STAGES[:run_stages(lcfg)],
                                   (lcfg.coarse2, lcfg.coarse3)):
        if scfg.detector_mode != "gumbel":
            continue
        g = scfg.grid_size or 4
        gen = torch.Generator(device=dev).manual_seed(int(
            np.random.SeedSequence([seed, step, level]).generate_state(1)[0]))
        u = torch.rand((B * world, (H // level // g) * (W // level // g),
                        g * g), generator=gen, device=dev)
        if world > 1:
            u = mesh.shard_rows({"u": u})["u"]
        out[f"sample_uniform_{name}"] = 1e-9 + (1.0 - 1e-9) * u
    return out


def forward_loss(model: nn.Module, batch: Dict[str, torch.Tensor], gt: Dict,
                 lcfg: LoftrConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward of ``model`` (in its current mode) on a batch from
    ``prepare_batch`` and the loss: (total, its named terms with each
    cascade stage's valid_n_{name})."""
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
    loss, scalars = casmtr_loss(out, gt, expec_gt, lcfg, c_weight=c_weight)
    for lvl, stage in out.cascades.items():
        scalars[f"valid_n_{lvl}"] = stage.matches.valid.sum()
    return loss, scalars


def _summed(scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scalars summed over the group (one all-reduce in float64): the
    loss terms' shares make the global terms, the counts the global
    counts.  Each keeps its dtype."""
    keys = sorted(scalars)
    vec = torch.stack([scalars[k].detach().double() for k in keys])
    vec = mesh.all_reduce_sum(vec)
    return {k: v.to(scalars[k].dtype) for k, v in zip(keys, vec)}


def make_train_step(model: nn.Module, cfg: Config, tx: AdamW, device=None
                    ) -> Callable:
    """Returns step_fn(state, batch) -> (state, scalars), scalars being the
    0-dim tensors loss, loss_8c, loss_f, grad_norm, valid_n_{name} for
    each cascade stage (4c; 4c and 2c for CasMTR-2c), and loss_{name} for
    each stage that found its ground truth (every stage of (4,) and (4,
    2)), with loss_{name}_det for a stage with a keypoint detector.  A gumbel
    detector draws its noise from ``detector_uniforms`` of the trainer's
    seed and the step.

    ``batch`` holds image0/image1 [B, H, W, 3], depth0/depth1 [B, H, W],
    K0/K1 [B, 3, 3], T_0to1/T_1to0 [B, 4, 4] and optionally mask0/mask1 and
    scale0/scale1, as tensors or numpy arrays.  ``device`` None means the
    card, which raises without CUDA; pass "cpu" to train on the CPU.

    Under a process group (``parallel.mesh.init_distributed``) ``batch`` is
    this rank's rows of the global batch and the step is the JAX step over
    the sharded global batch: the forward and loss run inside
    ``mesh.global_batch()`` (each rank's loss is its share of the global
    loss), the gradients and the scalars are summed over the group, and
    the clip norm and the skip decision read the sums, so every rank takes
    the same update."""
    dev = resolve_device(device)
    _set_precision(dev)
    lcfg = cfg.loftr

    def step_fn(state: TrainState, batch: Dict):
        grp = mesh.group()
        params = dict(model.named_parameters())
        # the forward moves the BatchNorm statistics; a skipped step restores
        stats = [b.clone() for b in model.buffers()]
        model.train()
        model.zero_grad(set_to_none=True)
        with mesh.global_batch():
            batch, gt = prepare_batch(batch, lcfg, dev)
            batch.update(detector_uniforms(lcfg, batch, cfg.trainer.seed,
                                           state.step))
            loss, scalars = forward_loss(model, batch, gt, lcfg)
            loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if grp is not None:
            mesh.all_reduce_grads(grads.values())
            scalars = _summed(scalars)
            loss = scalars["loss"]
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
