"""Optimizer, LR schedules and EMA (counterpart of casmtr_tpu/train/optim.py).

The JAX package builds these on optax; here they are functions of the step
and one small AdamW that computes what its optax chain computes:

    clip_by_global_norm(gradient_clipping)        # one norm over all groups
    -> multi_transform({main, vit, new, frozen}:
           scale_by_adam -> add_decayed_weights(wd) -> -lr(count) * scale)

The schedules read the optimizer's own update count, which a skipped step
(non-finite loss) does not advance.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional

import torch

from casmtr_tpu_torch.config import TrainerConfig


def scaling_ratio(tcfg: TrainerConfig, true_batch_size: int,
                  data_source: Optional[str] = None) -> float:
    """Batch-size scaling factor: linear in true_bs / canonical_bs; square
    root for ScanNet."""
    ratio = true_batch_size / tcfg.canonical_bs
    if data_source and data_source.lower() == "scannet":
        ratio = math.sqrt(ratio)
    return ratio


def scaled_lr(tcfg: TrainerConfig, true_batch_size: int,
              data_source: Optional[str] = None) -> float:
    """canonical_lr * scaling."""
    return tcfg.canonical_lr * scaling_ratio(tcfg, true_batch_size,
                                             data_source)


def scaled_warmup_step(tcfg: TrainerConfig, true_batch_size: int,
                       data_source: Optional[str] = None) -> int:
    """floor(warmup_step / scaling): smaller global batches warm up over
    proportionally more steps."""
    return math.floor(tcfg.warmup_step
                      / scaling_ratio(tcfg, true_batch_size, data_source))


def build_lr_schedule(tcfg: TrainerConfig, base_lr: float,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup, then MultiStepLR / CosineAnnealing / ExponentialLR.

    MultiStepLR keeps the reference's exact semantics: the warmup only SETS
    the lr while step < warmup, so the level after warmup is the LAST warmup
    value, and a milestone that falls inside the warmup is overwritten by the
    next warmup assignment and never takes effect."""
    milestones = tuple(tcfg.mslr_milestones)
    warm = tcfg.warmup_step
    linear_warmup = warm > 0 and tcfg.warmup_type == "linear"
    if tcfg.scheduler not in ("MultiStepLR", "CosineAnnealing",
                              "ExponentialLR"):
        raise NotImplementedError(tcfg.scheduler)

    def schedule(step: int) -> float:
        step = float(step)
        if tcfg.scheduler == "MultiStepLR":
            eff_base = base_lr
            if linear_warmup:
                w0f = tcfg.warmup_ratio * base_lr
                eff_base = w0f + ((warm - 1) / warm) * abs(base_lr - w0f)
            epoch = step // steps_per_epoch
            decay = 1.0
            for m in milestones:
                if m * steps_per_epoch >= warm and epoch >= m:
                    decay *= tcfg.mslr_gamma
            lr = eff_base * decay
        elif tcfg.scheduler == "CosineAnnealing":
            epoch = step / steps_per_epoch
            lr = (tcfg.min_lr + (base_lr - tcfg.min_lr) * 0.5
                  * (1 + math.cos(math.pi * min(epoch, tcfg.cosa_tmax)
                                  / tcfg.cosa_tmax)))
        else:
            lr = base_lr * tcfg.elr_gamma ** step
        if linear_warmup and step < warm:
            w0 = tcfg.warmup_ratio * base_lr
            lr = w0 + (step / warm) * abs(base_lr - w0)
        return lr

    return schedule


def new_stage_labels(names: Iterable[str]) -> Dict[str, str]:
    """'new' / 'old' label of each parameter name for the stage-resume
    warmup group: 'old' when the name contains 'backbone' or '8c'."""
    return {n: ("old" if ("backbone" in n.lower() or "8c" in n.lower())
                else "new") for n in names}


def stage_warmup_schedule(schedule, tcfg: TrainerConfig, base_lr: float,
                          restore_step: int, steps_per_epoch: int = 1):
    """Wrap a base schedule with the new-stage warmup: for
    ``warmup_step_stages`` steps after the restore point the new modules
    ramp linearly from ``warmup_ratio_stages * base_lr / 2`` toward
    ``base_lr / 2``, then stay at the ramp's last value, with only the
    milestone gammas at or after the window's end applied on top."""
    wss = tcfg.warmup_step_stages
    init = 0.5 * base_lr
    w0 = tcfg.warmup_ratio_stages * init
    milestones = tuple(tcfg.mslr_milestones)

    def staged(step: int) -> float:
        step = float(step)
        base = schedule(step)
        if wss <= 0 or step < restore_step:
            return base
        if step < restore_step + wss:
            return w0 + (step - restore_step) / wss * abs(init - w0)
        if tcfg.scheduler != "MultiStepLR":
            return base
        epoch = step // steps_per_epoch
        decay = 1.0
        for m in milestones:
            if m * steps_per_epoch >= restore_step + wss and epoch >= m:
                decay *= tcfg.mslr_gamma
        return (w0 + ((wss - 1) / wss) * abs(init - w0)) * decay

    return staged


@dataclass
class OptState:
    """AdamW state: the moments of every trainable parameter by name, the
    Adam update count (bias correction) and the schedules' count."""
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    schedule_count: int = 0
    labels: Dict[str, str] = field(default_factory=dict)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    norms = torch._foreach_norm(list(tensors))
    return torch.stack(norms).square().sum().sqrt()


class AdamW:
    """Per-group AdamW with one global-norm clip before the groups.

    ``groups`` maps a label to (lr scale, schedule); ``label_fn`` maps a
    parameter name to a label, or to 'frozen' (no update, left out of the
    clip norm).  ``update`` changes the parameters and the state in place."""

    def __init__(self, groups: Dict[str, tuple], label_fn, weight_decay: float,
                 clip: Optional[float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.groups = groups
        self.label_fn = label_fn
        self.weight_decay = weight_decay
        self.clip = clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        labels = {n: self.label_fn(n) for n in params}
        live = [n for n in params if labels[n] != "frozen"]
        return OptState(
            mu={n: torch.zeros_like(params[n]) for n in live},
            nu={n: torch.zeros_like(params[n]) for n in live},
            labels=labels)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: OptState) -> None:
        names = list(state.mu)
        g = [grads[n] for n in names]
        if self.clip:
            # optax: select(norm < max, g, (g / norm) * max)
            norm = global_norm(g)
            clipped = torch._foreach_mul(torch._foreach_div(g, norm),
                                         self.clip)
            keep = norm < self.clip
            g = [torch.where(keep, a, b) for a, b in zip(g, clipped)]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        state.count += 1
        m_hat = torch._foreach_div(mu, 1 - b1 ** state.count)
        denom = torch._foreach_div(nu, 1 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m_hat, denom)
        p = [params[n] for n in names]
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        for label, (scale, sched) in self.groups.items():
            idx = [i for i, n in enumerate(names) if state.labels[n] == label]
            if idx:
                lr = sched(state.schedule_count) * scale
                torch._foreach_add_([p[i] for i in idx], [upd[i] for i in idx],
                                    alpha=-lr)
        state.schedule_count += 1


def build_optimizer(tcfg: TrainerConfig, base_lr: float, steps_per_epoch: int,
                    new_param_labels: Optional[Dict[str, str]] = None,
                    restore_step: int = 0, frozen_label_fn=None) -> AdamW:
    """AdamW with the per-group ViT lr scale and one global gradient clip.

    ``new_param_labels`` (from new_stage_labels) gives the NEW parameters
    the stage warmup from ``restore_step``; ``frozen_label_fn(name) -> bool``
    excludes parameters from the update."""
    schedule = build_lr_schedule(tcfg, base_lr, steps_per_epoch)
    staged = (stage_warmup_schedule(schedule, tcfg, base_lr, restore_step,
                                    steps_per_epoch)
              if new_param_labels is not None else schedule)
    wd = tcfg.adamw_decay if tcfg.optimizer == "adamw" else tcfg.adam_decay

    def label_fn(name: str) -> str:
        if frozen_label_fn is not None and frozen_label_fn(name):
            return "frozen"
        if "vit" in name.lower():
            return "vit"
        if new_param_labels is not None and \
                new_param_labels.get(name) == "new":
            return "new"
        return "main"

    clip = tcfg.gradient_clipping
    return AdamW({"main": (1.0, schedule),
                  "vit": (tcfg.vit_lr_scale, schedule),
                  "new": (1.0, staged)}, label_fn, wd,
                 clip if clip and clip > 0 else None)


def set_schedule_step(opt_state: OptState, step: int) -> OptState:
    """``opt_state`` with its schedules' counter moved to ``step``, so that
    a resumed run continues its learning-rate schedule from the restored
    global step instead of re-entering warmup.  Only the schedule counter
    moves, as optax's ScaleByScheduleState in the JAX package's function:
    Adam's bias-correction ``count`` stays as restored (or 0 when fresh)."""
    return dataclasses.replace(opt_state, schedule_count=int(step))


def ema_beta_at(step: int, tcfg: TrainerConfig) -> float:
    """EMA decay with a linear warmup ramp."""
    min_steps = tcfg.steps_range[0]
    ramp = min(max((step - min_steps) / max(tcfg.ema_warmup, 1), 0.0), 1.0)
    return ramp * tcfg.ema_beta


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], beta: float) -> None:
    """p_ema <- p + beta * (p_ema - p), in place."""
    for n, e in ema_params.items():
        e.copy_(torch.lerp(params[n], e, beta))
