"""``dryrun_multichip(n)``: n processes, one data-parallel step each of the
four graph families that the JAX package's ``__graft_entry__.
dryrun_multichip`` jits over an n-device mesh, held against the
one-process step on the concatenated batch.

The families, at tiny widths on 64^2 pairs (the flagship 4c wiring, the
Twins backbone at its smallest): the 4c training step, the 2c training
step (the 1/2 level and coarse3), the PMT-refine training step (frozen
trunk, the ladder) and the eval forward under the global selection.  Each
process takes its rows of a seeded global batch of n pairs (random images,
image1 = image0, depth 1, the identity pose, as the JAX dry run) and seeded
random weights; the caller computes the same families in one process on
the whole batch.  The eval forward runs with zero thresholds, so every
stage's selection has candidates.

On the CPU the group is gloo and the gates are tests/test_parallel_train.
py's (every scalar within 1e-5 relative but grad_norm within 1e-3, each
with 1e-6 absolute; parameters within 5e-5 + 1e-4 |p| but for 0.5 % within
2 lr; BatchNorm statistics rtol 1e-4 / atol 1e-5; the eval forward's match
sets equal, confidences 1e-4, keypoints 1e-3 px).  On the card (the
default) everything runs in float32 (``CASMTR_*_BF16=0``), the group is
NCCL when every process has a card of its own and gloo otherwise, and the
gates are the card's float32 ones, as the kernels sum some gradients with
atomics: each loss term and grad_norm within 1e-4 relative (cosine does
not see a gradient off by a factor of the world), the gradient's cosine
>= 0.999, each selection's count within 2 picks (the caps of 16 bind, so
a top-M per rank would add 16 a rank), match sets' Jaccard >= 0.99 and
confidences 1e-4 on the common matches.  On both, the processes'
parameters after the step are equal.

    python -m casmtr_tpu_torch.parallel.dryrun 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from casmtr_tpu_torch.parallel import mesh

SIZE = 64
FAMILIES = ("4c train", "2c train", "refine train", "eval forward")
LR = 1e-3
CPU_GATES = dict(loss_rtol=1e-5, gnorm_rtol=1e-3, param_atol=5e-5,
                 param_rtol=1e-4, loose_share=1 / 200, bn_rtol=1e-4,
                 bn_atol=1e-5, conf_atol=1e-4, px_atol=1e-3)
CARD_GATES = dict(loss_rtol=1e-4, gnorm_rtol=1e-4, min_cos=0.999, picks=2,
                  min_jaccard=0.99, conf_atol=1e-4)
F32_ENV = {"CASMTR_BACKBONE_BF16": "0", "CASMTR_TRANSFORMER_BF16": "0"}


def tiny_overrides(levels=(4,), zero_thresholds: bool = False) -> Dict:
    """The flagship recipe at 64^2 with the JAX dry run's tiny widths
    (``__graft_entry__._tiny_model_overrides``)."""
    n = len(levels)
    lc = {
        "train_size": SIZE,
        "backbone": {"backbone_type": "Twins", "model_type": "small",
                     "initial_dim": 8, "block_dims": [8, 12, 16],
                     "refine_dims": [8, 12, 16]},
        "coarse": {"d_model": 16, "nhead": 2, "topks": [4, 4, 4],
                   "layer_names": ["self", "cross"]},
        "coarse2": {"d_model": 12, "nhead": 2, "window_size": 3,
                    "attn_window_size": 3,
                    "layer_names": ["cross", "self", "cross"]},
        "fine": {"d_model": 8, "nhead": 2},
        "match_coarse": {"max_matches": 16},
        "match_cascade": {"train_pad_num_gt_min": [16] * n,
                          "max_matches": [32] * n},
    }
    if n > 1:
        lc.update(cascade_levels=list(levels), training_stage=3,
                  fine_concat_coarse_feat=False)
        lc["coarse3"] = {"d_model": 8, "nhead": 2, "window_size": 3,
                         "attn_window_size": 3,
                         "layer_names": ["cross", "self"]}
        lc["match_cascade"] = {
            "thr": [0.0, 0.0], "pre_thr": [[0.0], [0.0, 0.0]],
            "test_thr": [0.2, 0.2], "border_rm": [2, 2],
            "double_check": [True, True], "match_type": ["softmax"] * 2,
            "dsmax_temperature": [1.0, 1.0],
            "train_pad_num_gt_min": [16, 16], "max_matches": [32, 32]}
    if zero_thresholds:
        lc["match_coarse"]["thr"] = 0.0
        lc["match_cascade"].update(test_thr=[0.0] * n,
                                   pre_thr=[[0.0] * (i + 1)
                                            for i in range(n)])
    return {"loftr": lc}


def tiny_batch(n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX dry run's global batch of ``n`` pairs."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, SIZE, SIZE, 3)).astype(np.float32)
    K = np.asarray([[[100.0, 0, SIZE / 2], [0, 100.0, SIZE / 2],
                     [0, 0, 1]]], np.float32).repeat(n, 0)
    T = np.eye(4, dtype=np.float32)[None].repeat(n, 0)
    return {"image0": img, "image1": img.copy(),
            "depth0": np.ones((n, SIZE, SIZE), np.float32),
            "depth1": np.ones((n, SIZE, SIZE), np.float32),
            "K0": K, "K1": K.copy(), "T_0to1": T, "T_1to0": T.copy()}


def _config(family: str):
    from casmtr_tpu_torch.config import override
    from casmtr_tpu_torch.configs import build_config
    levels = (4, 2) if family == "2c train" else (4,)
    return override(build_config("outdoor_casmtr_4c"), tiny_overrides(
        levels, zero_thresholds=family == "eval forward"))


def run_family(family: str, batch: Dict[str, np.ndarray], dev) -> Dict:
    """One family on ``batch`` on ``dev`` from the seeded weights: under a
    group, this process's part of the data-parallel step or forward."""
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    cfg = _config(family)
    refine = family == "refine train"
    model = build_model(cfg.loftr, refine=refine)
    init_random_(model, torch.Generator().manual_seed(0))
    if family == "eval forward":
        model.to(dev).eval()
        pair = {k: torch.from_numpy(batch[k]).to(dev)
                for k in ("image0", "image1")}
        with mesh.global_batch(), torch.inference_mode():
            fm = model(pair).final_matches
        out = {k: getattr(fm, k).cpu().numpy()
               for k in ("b_ids", "i_ids", "j_ids", "mkpts0", "mkpts1",
                         "mconf", "valid")}
        out["b_ids"] = out["b_ids"] + mesh.rank() * batch["image0"].shape[0]
        return out
    frozen = None
    if refine:
        from casmtr_tpu_torch.models.casmtr_refine import frozen_param_label
        frozen = frozen_param_label
    state, tx = init_train_state(model, cfg, 100, LR, frozen_label_fn=frozen,
                                 device=dev)
    _, scalars = make_train_step(model, cfg, tx, device=dev)(state, batch)
    return step_result(model, scalars)


def step_result(model, scalars) -> Dict:
    """What ``check_train`` compares of a step of ``model`` (its scalars):
    the scalars as floats, and on the CPU the gradients (zeros where none),
    the parameters after the update and the BatchNorm statistics."""
    return {
        "scalars": {k: float(v) for k, v in scalars.items()},
        "grads": {n: (p.grad if p.grad is not None
                      else torch.zeros_like(p)).detach().cpu()
                  for n, p in model.named_parameters()},
        "params": {n: p.detach().cpu().clone()
                   for n, p in model.named_parameters()},
        "stats": {n: b.detach().cpu().clone()
                  for n, b in model.named_buffers()
                  if n.endswith(("running_mean", "running_var"))}}


@contextlib.contextmanager
def _env(values: Dict[str, str]):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port() -> int:
    """A TCP port the OS has just handed out on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def spawn_world(n: int, argv: Callable[[int, int, str], List[str]],
                timeout_s: float, env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None):
    """Start a world of ``n`` processes, rank r running ``argv(r, port,
    out)`` (``port`` free on localhost, ``out`` a fresh directory where
    rank r saves its results to ``rank{r}.pt``).  Yields a function that
    waits for them and returns (each rank's results, each rank's output);
    it raises subprocess.TimeoutExpired past ``timeout_s`` from the start,
    and RuntimeError if a process exits nonzero.  Every process is killed
    when the block ends."""
    port = free_port()
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            argv(r, port, out), env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]

        def wait():
            logs = [p.communicate(timeout=max(0.0, deadline
                                              - time.monotonic()))[0]
                    for p in procs]
            for r, (p, text) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} of {n} exited "
                                       f"{p.returncode}:\n{text[-4000:]}")
            return [torch.load(os.path.join(out, f"rank{r}.pt"),
                               weights_only=False) for r in range(n)], logs
        try:
            yield wait
        finally:
            for p in procs:
                p.kill()
                p.wait()


def _worker(rank: int, n: int, port: int, device: str, out: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    dev = mesh.init_distributed(f"localhost:{port}", n, rank, device)
    try:
        batch = mesh.shard_rows(tiny_batch(n))
        results = {f: run_family(f, batch, dev) for f in FAMILIES}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cos(a: Dict, b: Dict) -> float:
    x = torch.cat([a[k].double().reshape(-1) for k in sorted(a)])
    y = torch.cat([b[k].double().reshape(-1) for k in sorted(a)])
    return float(x @ y / (x.norm() * y.norm()).clamp(min=1e-300))


def check_train(family: str, ranks, ref, card: bool, lr: float = LR
                ) -> Dict:
    """The gates of the module docstring for a training step at world n
    (``ranks``: each rank's ``step_result``) against one process on the
    whole batch (``ref``); AssertionError if one fails, else what it
    measured."""
    got = ranks[0]
    for other in ranks[1:]:
        for k, v in got["params"].items():
            if not torch.equal(v, other["params"][k]):
                raise AssertionError(f"{family}: ranks differ at {k}")
    r = ref["scalars"]
    for res in ranks:
        s = res["scalars"]
        if set(s) != set(r):
            raise AssertionError(f"{family}: scalars {sorted(s)} vs "
                                 f"{sorted(r)}")
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"{family}: non-finite loss {s['loss']}")
    s = got["scalars"]
    rel = {k: abs(s[k] - r[k]) / max(abs(r[k]), 1e-12)
           for k in r if k.startswith("loss")}
    out = {"loss": s["loss"], "ref_loss": r["loss"],
           "max_loss_rel": max(rel.values()),
           "grad_norm_rel": abs(s["grad_norm"] / r["grad_norm"] - 1),
           "grad_cos": _cos(got["grads"], ref["grads"]),
           "valid_n": {k: (s[k], r[k]) for k in s if k.startswith("valid")}}
    d = {k: (got["params"][k].double() - ref["params"][k].double()).abs()
         for k in ref["params"]}
    out["max_param_diff"] = max(float(v.max()) for v in d.values())
    out["max_stat_diff"] = max(
        [float((got["stats"][k] - v).abs().max())
         for k, v in ref["stats"].items()] or [0.0])
    if card:
        g = CARD_GATES
        picks = max([abs(a - b) for a, b in out["valid_n"].values()] or [0])
        if (out["max_loss_rel"] > g["loss_rtol"]
                or out["grad_norm_rel"] > g["gnorm_rtol"]
                or out["grad_cos"] < g["min_cos"] or picks > g["picks"]):
            raise AssertionError(f"{family}: {out}")
        return out
    g = CPU_GATES
    for res in ranks:
        for k, v in r.items():
            rtol = g["gnorm_rtol"] if k == "grad_norm" else g["loss_rtol"]
            if abs(res["scalars"][k] - v) > 1e-6 + rtol * abs(v):
                raise AssertionError(f"{family}: {k} {res['scalars'][k]} "
                                     f"vs {v}")
    n_loose = n_all = 0
    for k, dk in d.items():
        if float(dk.max()) >= 2 * lr:
            raise AssertionError(f"{family}: {k} moved {float(dk.max())} "
                                 "off the one-process step")
        tight = dk <= g["param_atol"] + g["param_rtol"] * (
            ref["params"][k].double().abs())
        n_loose += int((~tight).sum())
        n_all += dk.numel()
    if n_loose > max(1, int(n_all * g["loose_share"])):
        raise AssertionError(f"{family}: {n_loose} of {n_all} parameters "
                             "beyond the tight band")
    for k, v in ref["stats"].items():
        torch.testing.assert_close(got["stats"][k], v, rtol=g["bn_rtol"],
                                   atol=g["bn_atol"], msg=f"{family}: {k}")
    out["loose_params"] = n_loose
    return out


def _match_keys(m: Dict) -> Dict:
    v = m["valid"]
    return {(int(b), int(i), int(j)): (c, p0, p1) for b, i, j, c, p0, p1 in
            zip(m["b_ids"][v], m["i_ids"][v], m["j_ids"][v], m["mconf"][v],
                m["mkpts0"][v], m["mkpts1"][v])}


def _check_eval(ranks, ref, card: bool) -> Dict:
    got = {}
    for r in ranks:
        got.update(_match_keys(r))
    want = _match_keys(ref)
    common = set(got) & set(want)
    union = set(got) | set(want)
    out = {"matches": len(got), "ref_matches": len(want),
           "jaccard": len(common) / max(1, len(union))}
    conf = max([abs(float(got[k][0] - want[k][0])) for k in common] or [0])
    px = max([float(np.abs(np.concatenate(got[k][1:])
                           - np.concatenate(want[k][1:])).max())
              for k in common] or [0])
    out.update(max_conf_diff=conf, max_px_diff=px)
    if not want:
        raise AssertionError("eval forward: no matches to compare")
    if card:
        ok = (out["jaccard"] >= CARD_GATES["min_jaccard"]
              and conf <= CARD_GATES["conf_atol"])
    else:
        ok = (set(got) == set(want) and conf <= CPU_GATES["conf_atol"]
              and px <= CPU_GATES["px_atol"])
    if not ok:
        raise AssertionError(f"eval forward: {out}")
    return out


def dryrun_multichip(n: int, device=None, timeout_s: float = 600.0
                     ) -> Dict[str, Dict]:
    """Run the four families in ``n`` processes on ``device`` (None: the
    card, which raises without CUDA; "cpu" the CPU), each family also in
    this process on the whole batch, and hold them to the gates (module
    docstring); AssertionError if one fails, RuntimeError if a process
    fails, subprocess.TimeoutExpired (the processes killed) if one
    outlives ``timeout_s``.  Returns what each family measured."""
    from casmtr_tpu_torch.serving import resolve_device
    dev = resolve_device(device)
    card = dev.type == "cuda"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, **(F32_ENV if card else {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])

    def argv(r, port, out):
        return [sys.executable, "-m", "casmtr_tpu_torch.parallel.dryrun",
                str(n), "--device", dev.type, "--worker", str(r), "--port",
                str(port), "--out", out]
    with spawn_world(n, argv, timeout_s, env=env) as wait:
        batch = tiny_batch(n)
        threads = torch.get_num_threads()
        if not card:   # the refine step's CPU backward at batch 2 has
            torch.set_num_threads(1)   # crashed on 8 threads
        try:
            with _env(F32_ENV if card else {}):
                refs = {f: run_family(f, batch, dev) for f in FAMILIES}
        finally:
            torch.set_num_threads(threads)
        ranks, _ = wait()
    report = {}
    for f in FAMILIES:
        parts = [rk[f] for rk in ranks]
        report[f] = (_check_eval(parts, refs[f], card) if f == "eval forward"
                     else check_train(f, parts, refs[f], card))
        print(f"dryrun_multichip({n}, {dev.type}): {f} OK {report[f]}",
              flush=True)
    return report


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int)
    p.add_argument("--device", default=None, choices=("cpu", "cuda"),
                   help="default: the card")
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker, args.n, args.port, args.device, args.out)
    else:
        dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
