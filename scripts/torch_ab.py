#!/usr/bin/env python3
"""Two checkouts of the PyTorch port (casmtr_tpu_torch) timed in turns on one
NVIDIA GPU: kernels C and C-bwd, the serving request and the training step.

    python3 scripts/torch_ab.py OTHER

OTHER is the root of another checkout of the repository, for instance the
parent commit unpacked with ``git archive``.  Four processes run one after
another -- OTHER, this checkout, this checkout, OTHER -- each importing
``casmtr_tpu_torch`` from its own checkout (its kernels built there) and the
measuring code from this checkout's ``chip_smoke.py``:

- kernel C at the serving shapes (208^2 with H=4, 416^2 with H=2), C with
  its log-sum-exp and C-bwd at the training shapes (176^2, 352^2), w = 5,
  D = 32, through the public wrappers: each held against its plain version
  (chip_smoke.KERNEL_TOL) and timed by ``chip_smoke.time_ms``;
- ``chip_smoke.serving_phase`` and ``chip_smoke.training_phase`` for both
  recipes: three requests at bucket 832 (two steady), a warm-up and four
  steps at 704^2.

Prints the card's name and power limit, each process's lines, and last one
JSON object with every reading per checkout.  Exits non-zero without CUDA
or when any process fails.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "torch_ab: "
SHAPES = (("C", 208, 4), ("C", 416, 2), ("C with LSE", 176, 4),
          ("C with LSE", 352, 2), ("C-bwd", 176, 4), ("C-bwd", 352, 2))


def kernel_times(torch, cs):
    """C and C-bwd at SHAPES: {label: ms}."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for kind, grid, H in SHAPES:
        corners = cs.window_inputs(torch, gen, grid // 2)
        q, k, v = (torch.randn((1, grid * grid, H, 32), generator=gen,
                               device="cuda") for _ in range(3))
        hw = (grid, grid)
        out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
            q, k, v, corners, hw, hw, 5, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        if kind == "C":
            want = (out,)

            def fn():
                return (wk.window_cross_attention(q, k, v, corners, hw, hw,
                                                  5),)
        elif kind == "C with LSE":
            want = (out, lse)

            def fn():
                return wk._launch_wca_fwd(q, k, v, corners, hw, hw, 5, True)
        else:
            want = wk.window_cross_attention_bwd_plain(q, k, v, corners, out,
                                                       lse, g, hw, hw, 5)

            def fn():
                return wk.window_cross_attention_bwd(q, k, v, corners, out,
                                                     lse, g, hw, hw, 5)
        got = fn()
        torch.cuda.synchronize()
        label = f"{kind} {grid}^2 H={H}"
        for i, (a, b) in enumerate(zip(got, want)):
            tol = cs.KERNEL_TOL * (max(1.0, float(b.abs().max()))
                                   if kind == "C-bwd" and i else 1.0)
            err = float((a - b).abs().max())
            cs.check(err <= tol, f"{label}: output {i} max abs error "
                     f"{err:.3e} > {tol:.3g}")
        times[label] = cs.time_ms(torch, fn)
        print(f"{TAG}{label}: {times[label]:.4f} ms", flush=True)
    return times


def child(tree):
    """One checkout's readings, printed as the last line."""
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
    res = {"kernels_ms": kernel_times(torch, cs), "serving_ms": {},
           "step_s": {}}
    for recipe in cs.RECIPES:
        res["serving_ms"][recipe] = cs.serving_phase(torch, recipe)[4]
        torch.cuda.empty_cache()
    for recipe in cs.RECIPES:
        res["step_s"][recipe] = cs.training_phase(torch, recipe)[5]
        torch.cuda.empty_cache()
    print(TAG + json.dumps(res), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = {"other": [], "this": []}
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree)],
                              capture_output=True, text=True, cwd=tree)
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            print(f"{name}: {line[:160]}", flush=True)
        if proc.returncode or not lines or not lines[-1].startswith(TAG):
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"torch_ab: the {name} checkout's run failed", file=sys.stderr)
            return 1
        runs[name].append(json.loads(lines[-1][len(TAG):]))
    print(json.dumps({"other": str(other), "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
