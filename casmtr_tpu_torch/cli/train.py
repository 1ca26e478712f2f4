"""The training command of the port (counterpart of casmtr_tpu/cli/train.py):

    python -m casmtr_tpu_torch.cli.train --model outdoor_casmtr_4c \
        --data megadepth_trainval_704 --run-dir runs/x

and data-parallel over processes, one device each, launched by torchrun
(``--dist``) or by hand (``--dist-coordinator host:port
--dist-num-processes N --dist-process-id I`` in each process):

    torchrun --nproc-per-node 4 -m casmtr_tpu_torch.cli.train --dist ...

reads the data recipe's train and val splits from disk (``data/module.
MultiSceneDataModule``; point them elsewhere with ``--overrides-json``),
scales the learning rate and warmup to the batch, runs a sanity
validation, trains with a validation per ``--val-every-epochs`` epochs,
keeps the best checkpoints by auc@10 and always the newest (``run-dir/
ckpts``), and resumes (``--resume``, stage-aware through ``resume_state``).

A run starts with ``train_step.init_train_state`` and saves
``train.checkpoints.checkpoint_state`` of its state through a
``CheckpointManager``; a later run (the same stage, or the next stage of a
staged recipe) builds its own fresh state and passes it with the restored
checkpoint to ``resume_state``.

Under a group (``parallel.mesh``) the batch size is per process: the
global batch is ``--batch-size`` x the processes, the learning rate and
warmup scale by it, each process reads its own training scenes, every
step is the JAX step over the global batch (``train_step.
make_train_step``), validation gathers its metrics from every process,
and only process 0 writes ``config.json``, the checkpoints and the NaN
dump; the other processes log errors only.

Process 0 writes TensorBoard events to ``run-dir/tb`` (``utils/logging.
TensorBoardWriter``, stdlib only): ``train/*`` and ``lr`` every
``--log-every`` steps, ``val/*`` after each validation, and a match figure
``val_match/pair-{n}`` every ``--plot-every`` validation pairs
(``utils/plotting``'s raster).

Validation poses each pair by the reference protocol on the host, as the
JAX command does (``utils/metrics.estimate_pose``, the port's own
essential-matrix RANSAC and ``recoverPose``, no OpenCV).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from casmtr_tpu_torch.cli.evaluate import run_eval
from casmtr_tpu_torch.config import Config, dump, override
from casmtr_tpu_torch.configs import build_config
from casmtr_tpu_torch.data.loader import _ARRAY_KEYS
from casmtr_tpu_torch.data.module import MultiSceneDataModule
from casmtr_tpu_torch.models import build_model
from casmtr_tpu_torch.parallel import mesh
from casmtr_tpu_torch.serving import resolve_device
from casmtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                                checkpoint_state,
                                                load_into_state)
from casmtr_tpu_torch.train.optim import (AdamW, OptState, build_lr_schedule,
                                          build_optimizer, new_stage_labels,
                                          scaled_lr, scaled_warmup_step,
                                          set_schedule_step)
from casmtr_tpu_torch.train.train_step import (TrainState, init_train_state,
                                               make_train_step)
from casmtr_tpu_torch.utils.logging import TensorBoardWriter, get_logger
from casmtr_tpu_torch.weights import init_random_


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


def _replicated(state: TrainState):
    """The tensors every process must hold alike, in one order: the
    model's parameters and buffers, the optimizer's moments and the EMA
    parameters."""
    yield from state.model.parameters()
    yield from state.model.buffers()
    for moments in (state.opt_state.mu, state.opt_state.nu,
                    state.ema_params or {}):
        yield from (moments[n] for n in sorted(moments))


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The training step's inputs of a loader batch on ``device``: its
    numpy arrays among the loader's stacked keys (names and ids stay
    behind)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()
            if k in _ARRAY_KEYS and isinstance(v, np.ndarray)}


def run_validation(cfg: Config, model: torch.nn.Module, val_loader,
                   max_pairs: int = 200, device=None, tb=None, step: int = 0,
                   plot_every: int = 32) -> Dict:
    """One validation pass of ``model`` over at most ``max_pairs`` pairs of
    ``val_loader``: ``evaluate.run_eval`` on the loader (each pair posed
    by the reference protocol on the host, as the JAX function does), or
    {} without pairs.  With ``tb`` (a ``TensorBoardWriter``)
    the first pair of every ``plot_every``-th batch (by pairs seen) is
    drawn (``make_evaluation_figure`` of its valid matches and epipolar
    errors) as ``val_match/pair-{n}`` at ``step``, as the JAX function
    does.  The model is left in eval mode (the training step puts it back
    in train mode)."""
    on_batch = None
    if tb is not None:
        from casmtr_tpu_torch.utils.plotting import make_evaluation_figure

        def on_batch(n, batch, out_np, metrics):
            if n % plot_every or not metrics["epi_errs"]:
                return
            sel = out_np["valid"] & (out_np["b_ids"] == 0)
            fig = make_evaluation_figure(
                np.asarray(batch["image0"][0]).mean(-1),
                np.asarray(batch["image1"][0]).mean(-1),
                out_np["mkpts0"][sel], out_np["mkpts1"][sel],
                metrics["epi_errs"][-batch["K0"].shape[0]],
                cfg.trainer.epi_err_thr)
            tb.figure(f"val_match/pair-{n}", fig, step)
    return run_eval(cfg, model, max_pairs=max_pairs, device=device,
                    loader=val_loader, on_batch=on_batch, pose_solver="cv2")


def _validate(cfg, state: TrainState, val_loader, max_pairs, device,
              **kw):
    """``run_validation`` of the state's model (``kw``: its figure
    arguments), with the EMA parameters in place of the raw ones when
    ``trainer.test_ema`` (the raw ones come back after it)."""
    if not (cfg.trainer.test_ema and state.ema_params is not None):
        return run_validation(cfg, state.model, val_loader, max_pairs, device,
                              **kw)
    params = dict(state.model.named_parameters())
    raw = {n: p.detach().clone() for n, p in params.items()}
    print("validation uses EMA params (trainer.test_ema=True)")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state.ema_params[n])
    results = run_validation(cfg, state.model, val_loader, max_pairs, device,
                             **kw)
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(raw[n])
    return results


def main(argv=None) -> Dict:
    """The training command.  Returns {"step", "run_dir", "val"} (the
    final step, the run directory and the last validation's results)."""
    p = argparse.ArgumentParser(
        description="CasMTR training in PyTorch, on one device or "
                    "data-parallel over processes")
    p.add_argument("--model", default="outdoor_casmtr_4c")
    p.add_argument("--data", default="megadepth_trainval_704")
    p.add_argument("--run-dir", default="runs/default")
    p.add_argument("--batch-size", type=int, default=1,
                   help="batch size per process")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--stage", type=int, default=None,
                   help="training stage override (1 = coarse only, "
                        "2 = + cascade)")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from (non-strict "
                        "for new stages)")
    p.add_argument("--reset-lr", action="store_true")
    p.add_argument("--refine", action="store_true",
                   help="PMT refine: frozen quadtree trunk + ladder + cas_ "
                        "heads")
    p.add_argument("--quadtree-ckpt", default=None,
                   help="pretrained quadtree checkpoint for --refine (a "
                        "reference .ckpt/.pth or a port checkpoint "
                        "directory)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--val-every-epochs", type=int, default=1)
    p.add_argument("--max-val-pairs", type=int, default=200)
    p.add_argument("--plot-every", type=int, default=32,
                   help="a validation match figure every N pairs "
                        "(TensorBoard, run-dir/tb)")
    p.add_argument("--sanity-val-steps", type=int, default=2,
                   help="val pairs to run before training")
    p.add_argument("--seed", type=int, default=66)
    p.add_argument("--overrides-json", default=None,
                   help="inline JSON config overrides (applied last)")
    p.add_argument("--device", default=None,
                   help="where the model trains (default: the card, "
                        "'cuda'; 'cpu' for the CPU)")
    p.add_argument("--dist", action="store_true",
                   help="data-parallel over the processes of a launcher "
                        "(torchrun: RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--dist-coordinator", default=None,
                   help="host:port of process 0 (data-parallel, launched by "
                        "hand; with the two below)")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)
    args = p.parse_args(argv)

    if args.dist or args.dist_coordinator:
        device = mesh.init_distributed(args.dist_coordinator,
                                       args.dist_num_processes,
                                       args.dist_process_id, args.device)
    else:
        device = resolve_device(args.device)
    world, rank = mesh.world_size(), mesh.rank()
    main_process = rank == 0
    overrides = {"trainer": {"seed": args.seed}}
    if args.stage is not None:
        overrides["loftr"] = {"training_stage": args.stage}
    cfg = build_config(args.model, args.data, overrides)
    if args.overrides_json:
        cfg = override(cfg, json.loads(args.overrides_json))
    global_bs = args.batch_size * world
    base_lr = scaled_lr(cfg.trainer, global_bs,
                        cfg.dataset.trainval_data_source)
    # warmup steps scale inversely with the batch; the dumped config holds
    # the scaled value, so a resume reuses it as it is
    cfg = override(cfg, {"trainer": {"warmup_step": scaled_warmup_step(
        cfg.trainer, global_bs, cfg.dataset.trainval_data_source)}})
    print(f"device={device} processes={world} global_bs={global_bs} "
          f"lr={base_lr:.2e} warmup={cfg.trainer.warmup_step}")
    os.makedirs(args.run_dir, exist_ok=True)
    if main_process:
        dump(cfg, os.path.join(args.run_dir, "config.json"))
    tb = TensorBoardWriter(os.path.join(args.run_dir, "tb"))
    log = get_logger()

    dm = MultiSceneDataModule(cfg, world_size=world, rank=rank)
    train_loader = dm.train_loader(args.batch_size,
                                   num_workers=args.num_workers)
    val_loader = dm.eval_loader(dm.val_dataset(), batch_size=1,
                                num_workers=args.num_workers)
    steps_per_epoch = max(1, len(train_loader))

    frozen_fn = None
    if args.refine:
        from casmtr_tpu_torch.models.casmtr_refine import frozen_param_label
        frozen_fn = frozen_param_label
    model = build_model(cfg.loftr, refine=args.refine)
    init_random_(model, torch.Generator().manual_seed(cfg.trainer.seed))
    if args.refine and args.quadtree_ckpt:
        # non-strict trunk load: the ladder and cas_ heads keep their init
        if args.quadtree_ckpt.endswith((".ckpt", ".pth")):
            from casmtr_tpu_torch.utils.convert import (convert_state_dict,
                                                        load_torch_checkpoint)
            report = convert_state_dict(
                load_torch_checkpoint(args.quadtree_ckpt), model,
                strict=False)
            print(f"quadtree trunk loaded: {len(report['missing'])} fresh, "
                  f"{len(report['unused'])} unused")
        else:
            restored = CheckpointManager(args.quadtree_ckpt).restore()
            if restored is not None:
                load_into_state(restored["state_dict"], model)
    state, tx = init_train_state(model, cfg, steps_per_epoch, base_lr,
                                 frozen_label_fn=frozen_fn, device=device)
    ckpt_mgr = CheckpointManager(os.path.join(args.run_dir, "ckpts"),
                                 metric_name="auc@10")
    # the NaN dump has its own manager: beside the real checkpoints it
    # would be dropped as a low-metric entry
    nan_mgr = None
    lr_sched = build_lr_schedule(cfg.trainer, base_lr, steps_per_epoch)
    if args.resume:
        restored = CheckpointManager(args.resume).restore()
        if restored is not None:
            state, tx, lr_sched = resume_state(
                cfg, state, restored, base_lr, steps_per_epoch,
                reset_lr=args.reset_lr, resume_dir=args.resume,
                frozen_label_fn=frozen_fn, global_bs=global_bs)
            print(f"resumed from {args.resume} at step {state.step}")
    if world > 1:   # every process starts from process 0's state
        mesh.broadcast_state(_replicated(state))
    step_fn = make_train_step(model, cfg, tx, device=device)

    if args.sanity_val_steps > 0:
        # catches a broken validation path before a training epoch
        run_validation(cfg, model, val_loader,
                       max_pairs=args.sanity_val_steps, device=device)
        print(f"sanity validation ok ({args.sanity_val_steps} pairs)")

    results: Dict = {}
    for epoch in range(args.epochs):
        # data_s: host time blocked on the loader; step_s: the rest of the
        # step (its scalars are read at each log line, which waits for the
        # card).  A loader-bound run shows data_s well above 0.  The first
        # window is labelled compile_s, as in the JAX command: PyTorch
        # compiles nothing, but the first step builds the kernels and pays
        # cuDNN's autotuning.
        t0 = time.time()
        t_data = 0.0
        t_mark = time.time()
        win_t0, win_data, win_n = time.time(), 0.0, 0
        for i, batch in enumerate(train_loader):
            dt_data = time.time() - t_mark
            t_data += dt_data
            win_data += dt_data
            state, scalars = step_fn(state, device_batch(batch, device))
            win_n += 1
            if i % args.log_every == 0:
                s = {k: float(v) for k, v in scalars.items()}
                now = time.time()
                s["lr"] = float(lr_sched(state.step))
                tb.scalars({f"train/{k}": v for k, v in s.items()},
                           state.step)
                win_step = (now - win_t0 - win_data) / win_n
                cum_step = (now - t0 - t_data) / (i + 1)
                step_tag = "compile_s" if i == 0 and epoch == 0 else "step_s"
                rate = win_n / (now - win_t0 + 1e-9)
                print(f"epoch {epoch} step {i}/{steps_per_epoch} "
                      f"loss={s['loss']:.4f} {rate:.2f} it/s "
                      f"data_s={win_data / win_n:.3f} "
                      f"{step_tag}={win_step:.3f} avg_step_s={cum_step:.3f} "
                      + " ".join(
                          f"{k}={v:.2e}" if k == "lr" else f"{k}={v:.3f}"
                          for k, v in s.items() if k != "loss"), flush=True)
                win_t0, win_data, win_n = time.time(), 0.0, 0
                if not np.isfinite(s["loss"]):
                    # the step skips its update on a non-finite loss, so
                    # the dump holds the last good state
                    if not main_process:
                        raise RuntimeError(f"NaN loss at step {state.step}")
                    if nan_mgr is None:
                        nan_mgr = CheckpointManager(
                            os.path.join(args.run_dir, "nan_dump"),
                            max_to_keep=1, keep_last=False)
                    nan_mgr.save(state.step, checkpoint_state(state))
                    raise RuntimeError(f"NaN loss at step {state.step}")
            t_mark = time.time()

        if (epoch + 1) % args.val_every_epochs == 0:
            results = _validate(cfg, state, val_loader, args.max_val_pairs,
                                device, tb=tb, step=state.step,
                                plot_every=args.plot_every)
            tb.scalars({f"val/{k}": float(v) for k, v in results.items()},
                       state.step)
            tb.flush()
            log.info("epoch %d val: %s", epoch, json.dumps(
                {k: round(float(v), 4) for k, v in results.items()}))
            if main_process:
                ckpt_mgr.save(state.step, checkpoint_state(state),
                              {k: float(v) for k, v in results.items()})

    # the final save: epochs past the last validation would be lost
    if main_process and ckpt_mgr.latest_step() != state.step:
        ckpt_mgr.save(state.step, checkpoint_state(state), {"auc@10": -1.0})
        print(f"final checkpoint saved at step {state.step}")
    tb.close()
    return {"step": state.step, "run_dir": args.run_dir, "val": results}


if __name__ == "__main__":
    main()
