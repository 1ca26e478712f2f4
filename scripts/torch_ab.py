#!/usr/bin/env python3
"""Two checkouts of the PyTorch port (casmtr_tpu_torch) timed in turns on one
NVIDIA GPU: kernels A, A′, A-bwd, B, B-bwd, C and C-bwd, the serving
request and the training step.

    python3 scripts/torch_ab.py [--kernels] OTHER

OTHER is the root of another checkout of the repository, for instance the
parent commit unpacked with ``git archive``.  Four processes run one after
another -- OTHER, this checkout, this checkout, OTHER -- each importing
``casmtr_tpu_torch`` from its own checkout (its kernels built there) and the
measuring code from this checkout's ``chip_smoke.py``:

- the kernels at their main-path shapes (SHAPES), through the public
  wrappers and the launchers (``_launch_fwd`` for a forward with its
  log-sum-exp): A at the finest level of the 832^2 eval (104^2) and, with
  its LSE, of the 704^2 step (88^2); A′ (top 16) at the intermediate
  levels, 52^2 and 44^2 with its LSE; A-bwd at 88^2 and 44^2; C at the
  serving shapes (208^2 with H=4, 416^2 with H=2), C with its LSE and C-bwd
  at the training shapes (176^2, 352^2), w = 5, D = 32; B at the serving
  (208^2 with C=128, 416^2 with C=64) and training shapes (176^2, 352^2),
  B-bwd at the training shapes, on chip_smoke.window_inputs' corners.  Each
  is held against its plain version (chip_smoke.KERNEL_TOL; A′ by message
  and sorted scores), timed on the card by ``chip_smoke.time_ms`` and on the
  host by ``host_us`` (one call's enqueue, the card held busy);
- ``chip_smoke.serving_phase`` and ``chip_smoke.training_phase`` for both
  recipes: three requests at bucket 832 (two steady), and a warm-up and
  four steps at 704^2, each in the card's bf16 default and again with
  float32 forced; after each training run one more step under
  torch.profiler (``host_step``): its wall, host and device time and its
  CUDA API calls (cuda* and cu*).  Both phases hold each request and step
  to chip_smoke's launch counts, so OTHER must have the bf16 eval and
  training policy (its bf16 kernel instances) too; against an older
  checkout use ``--kernels``.

With ``--kernels`` the processes time only the kernels, for instance to
split a kernel into its passes: OTHER is then a copy of this checkout whose
kernel source was edited to leave a pass out, so OTHER's outputs are
printed beside the plain versions' but not checked.

Prints the card's name and power limit, each process's lines, and last one
JSON object with every reading per checkout.  Exits non-zero without CUDA
or when any process fails.
"""

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "torch_ab: "
# (kernel, grid of the level, heads; channels for B and B-bwd): the quadtree
# rows take H=8, D=32 and K=16 (finest) or 32 (intermediate) from
# chip_smoke.quadtree_inputs
SHAPES = (("A", 104, 8), ("A with LSE", 88, 8), ("A′", 52, 8),
          ("A′ with LSE", 44, 8), ("A-bwd", 88, 8), ("A-bwd", 44, 8),
          ("B", 208, 128), ("B", 416, 64), ("B", 176, 128), ("B", 352, 64),
          ("B-bwd", 176, 128), ("B-bwd", 352, 64),
          ("C", 208, 4), ("C", 416, 2), ("C with LSE", 176, 4),
          ("C with LSE", 352, 2), ("C-bwd", 176, 4), ("C-bwd", 352, 2))
TOPK = 16   # A′'s selection: the 1/8 stack's second topk
# CUDA API calls (cuda* and cu*) in which the host can wait for the card
WAITS = ("Synchronize", "Memcpy")


def _level(torch, cs, gen, cache, grid):
    """chip_smoke's quadtree level ((q, k, v), ids, hw) on a grid x grid
    query grid: the finest level of the 104^2 or 88^2 pyramid, or its
    intermediate level."""
    g8 = grid if grid in (104, 88) else 2 * grid
    if g8 not in cache:
        cache[g8] = cs.quadtree_inputs(torch, gen, g8)
    inter, finest = cache[g8].values()
    return finest if grid == g8 else inter


def _quadtree_case(torch, cs, gen, cache, kind, grid):
    """(fn, want, scattered outputs) of a quadtree row."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    (q, k, v), ids, hw = _level(torch, cs, gen, cache, grid)
    if kind == "A":
        return (lambda: (qk_.quadtree_fine_attention(q, k, v, ids, hw, hw),),
                (qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw),),
                ())
    if kind == "A with LSE":
        return (lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2],
                qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw, True),
                ())
    if kind == "A′":   # the public wrapper; scores in descending order
        p_msg, p_score, _ = qk_.quadtree_fine_topk_plain(q, k, v, ids, hw, hw,
                                                         TOPK)
        return (lambda: qk_.quadtree_fine_topk(q, k, v, ids, hw, hw,
                                               TOPK)[:2],
                (p_msg, p_score), ())
    if kind == "A′ with LSE":
        p_msg, p_score, _, p_lse = qk_.quadtree_fine_topk_plain(
            q, k, v, ids, hw, hw, TOPK, True)
        return (lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True,
                                        TOPK)[:3],
                (p_msg, p_lse, p_score), ())
    out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
        q, k, v, ids, hw, hw, True))
    g = torch.randn(out.shape, generator=gen, device="cuda")
    return (lambda: qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                    g, hw, hw),
            qk_.quadtree_fine_attention_bwd_plain(q, k, v, ids, out, lse, g,
                                                  hw, hw), (1, 2))


def _score_case(torch, cs, gen, kind, grid, C):
    """(fn, want, scattered outputs) of a B or B-bwd row, on chip_smoke's
    window corners (w = 5) and inputs."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    corners = cs.window_inputs(torch, gen, grid // 2)
    P = corners.shape[1]
    q = torch.randn((1, P, 4, C), generator=gen, device="cuda") * C ** -0.25
    feat1 = torch.randn((1, grid, grid, C), generator=gen,
                        device="cuda") * C ** -0.25
    if kind == "B":
        return (lambda: (wk.window_patch_score(q, feat1, corners, 5),),
                (wk.window_patch_score_plain(q, feat1, corners, 5),), ())
    g = torch.randn((1, P, 4, 100), generator=gen, device="cuda")
    return (lambda: wk.window_patch_score_bwd(q, feat1, corners, g, 5),
            wk.window_patch_score_bwd_plain(q, feat1, corners, g, 5), (1,))


def _window_case(torch, cs, gen, kind, grid, H):
    """(fn, want, scattered outputs) of a C or C-bwd row."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    corners = cs.window_inputs(torch, gen, grid // 2)
    q, k, v = (torch.randn((1, grid * grid, H, 32), generator=gen,
                           device="cuda") for _ in range(3))
    hw = (grid, grid)
    out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
        q, k, v, corners, hw, hw, 5, with_lse=True))
    g = torch.randn(out.shape, generator=gen, device="cuda")
    if kind == "C":
        return (lambda: (wk.window_cross_attention(q, k, v, corners, hw, hw,
                                                   5),), (out,), ())
    if kind == "C with LSE":
        return (lambda: wk._launch_wca_fwd(q, k, v, corners, hw, hw, 5, True),
                (out, lse), ())
    return (lambda: wk.window_cross_attention_bwd(q, k, v, corners, out, lse,
                                                  g, hw, hw, 5),
            wk.window_cross_attention_bwd_plain(q, k, v, corners, out, lse,
                                                g, hw, hw, 5), (1, 2))


def host_us(torch, cs, fn, reps=25):
    """Median host time of one call of ``fn`` in us: Python, argument
    checks, allocations and launches.  The card spins for
    chip_smoke.HOLD_CYCLES before each call, so no call waits for it."""
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cs.HOLD_CYCLES)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def kernel_times(torch, cs, checked=True):
    """The kernels at SHAPES, each first held against its plain version
    (only printed when not ``checked``): ({label: device ms}, {label: host
    us})."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cache = {}
    times, host = {}, {}
    for kind, grid, H in SHAPES:
        if kind.startswith("A"):
            fn, want, scattered = _quadtree_case(torch, cs, gen, cache, kind,
                                                 grid)
        elif kind.startswith("B"):
            fn, want, scattered = _score_case(torch, cs, gen, kind, grid, H)
        else:
            fn, want, scattered = _window_case(torch, cs, gen, kind, grid, H)
        label = f"{kind} {grid}^2 " + (f"C={H}" if kind.startswith("B")
                                        else f"H={H}")
        got = fn()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            tol = (cs.SCORE_TOL if kind.startswith("A′") and i ==
                   len(want) - 1 else cs.KERNEL_TOL)
            if i in scattered:
                tol *= max(1.0, float(b.abs().max()))
            err = float((a - b).abs().max())
            if not checked:
                print(f"{TAG}{label}: output {i} max abs error {err:.3e} "
                      "(not checked)", flush=True)
                continue
            cs.check(err <= tol, f"{label}: output {i} max abs error "
                     f"{err:.3e} > {tol:.3g}")
        times[label] = cs.time_ms(torch, fn)
        host[label] = host_us(torch, cs, fn)
        print(f"{TAG}{label}: {times[label]:.4f} ms, host "
              f"{host[label]:.1f} us", flush=True)
    return times, host


def host_step(torch, step, state, batch):
    """One more training step under torch.profiler: its wall time, the
    host's share (wall less the CUDA calls that can wait for the card, per
    WAITS), the device time summed over its kernels (ms), and
    {call: [count, ms]} of its CUDA API calls (cuda* and cu*)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    calls, busy = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy += e.self_device_time_total / 1e3
        elif e.key.startswith("cu"):
            calls[e.key] = [e.count, e.cpu_time_total / 1e3]
    waits = sum(ms for key, (_, ms) in calls.items()
                if any(w in key for w in WAITS))
    return {"wall_ms": wall, "host_ms": wall - waits, "device_ms": busy,
            "calls": calls}


def child(tree, kernels_only=False):
    """One checkout's readings, printed as the last line; with
    ``kernels_only`` only the kernels'."""
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import casmtr_tpu_torch
    pkg = Path(casmtr_tpu_torch.__file__).resolve()
    cs.check(pkg.is_relative_to(tree), f"imported {pkg}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"serving_ms": {}, "step_s": {}, "step_profile": {}}
    res["kernels_ms"], res["kernels_host_us"] = kernel_times(
        torch, cs, checked=not kernels_only or tree == ROOT)
    if kernels_only:
        print(TAG + json.dumps(res), flush=True)
        return
    for recipe in cs.RECIPES:
        precisions, _, _ = cs.serving_phase(torch, recipe)
        for prec, (_, _, steady) in precisions.items():
            res["serving_ms"][f"{recipe} {prec}"] = steady
        torch.cuda.empty_cache()
    for recipe in cs.RECIPES:
        for prec in ("bf16", "f32"):
            key = f"{recipe} {prec}"
            with cs.precision(prec):
                _, _, step, state, batch, times = cs.training_phase(
                    torch, recipe, prec)
                res["step_s"][key] = times
                prof = host_step(torch, step, state, batch)
            res["step_profile"][key] = prof
            print(f"{TAG}{key} profiled step: wall {prof['wall_ms']:.1f} ms, "
                  f"host {prof['host_ms']:.1f}, device "
                  f"{prof['device_ms']:.1f}", flush=True)
            del step, state, batch
            torch.cuda.empty_cache()
    print(TAG + json.dumps(res), flush=True)


def run_children(plan, flags):
    """Run (name, tree) children in order, each with ``flags``; {name:
    [readings]}, or None when one fails."""
    runs = {}
    for name, tree in plan:
        proc = subprocess.run([sys.executable, __file__, *flags, "--child",
                               str(tree)],
                              capture_output=True, text=True, cwd=tree)
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            print(f"{name}: {line[:160]}", flush=True)
        if proc.returncode or not lines or not lines[-1].startswith(TAG):
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"torch_ab: the {name} run failed", file=sys.stderr)
            return None
        runs.setdefault(name, []).append(json.loads(lines[-1][len(TAG):]))
    return runs


def summary(runs):
    """Print, per reading, the median over each checkout's processes (and
    over the requests or steps within them)."""
    def med(name, get):
        vals = []
        for res in runs[name]:
            got = get(res)
            vals.extend(got if isinstance(got, list) else [got])
        return statistics.median(vals)

    for label in runs["this"][0]["kernels_ms"]:
        o, t = (med(n, lambda r: r["kernels_ms"][label])
                for n in ("other", "this"))
        ho, ht = (med(n, lambda r: r["kernels_host_us"][label])
                  for n in ("other", "this"))
        print(f"{TAG}summary {label}: other {o:.4f} ms, this {t:.4f} ms "
              f"(other/this {o / t:.2f}x); host other {ho:.1f} us, this "
              f"{ht:.1f} us", flush=True)
    for key, unit in (("serving_ms", "ms"), ("step_s", "s")):
        for recipe in runs["this"][0][key]:
            o, t = (med(n, lambda r: r[key][recipe])
                    for n in ("other", "this"))
            print(f"{TAG}summary {recipe} {key}: other {o:.4f} {unit}, "
                  f"this {t:.4f} {unit}", flush=True)


def main():
    args = sys.argv[1:]
    flags = [a for a in args if a == "--kernels"]
    args = [a for a in args if a != "--kernels"]
    if len(args) == 2 and args[0] == "--child":
        child(Path(args[1]).resolve(), kernels_only=bool(flags))
        return 0
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    other = Path(args[0]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = run_children([("other", other), ("this", ROOT), ("this", ROOT),
                         ("other", other)], flags)
    if runs is None:
        return 1
    summary(runs)
    print(json.dumps({"other": str(other), "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
