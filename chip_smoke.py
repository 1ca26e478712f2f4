#!/usr/bin/env python3
"""Smoke test of the PyTorch port (casmtr_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines and its seconds:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the CUDA kernels from csrc/ with nvcc.
2. Kernels: each CUDA kernel of the serving path against its plain PyTorch
   version on the card, at the shapes of the flagship outdoor_casmtr_4c eval
   at 832^2 with realistic indices (a real top-k, real window corners), in
   float32 with TF32 off; max abs error <= 1e-4.  Kernel and plain version
   are timed with CUDA events (median of 25 launches, L2 flushed before
   each), beside the least time the card needs for the same work.
3. Training kernels: the same at the shapes of the 704^2 training step for
   the forward kernels with their log-sum-exp output and for the three
   backward kernels (A-bwd at 88^2 and 44^2, B-bwd and C-bwd at 176^2).  dq
   within 1e-4; the atomically summed dk, dv and dfeat1 within
   1e-4 x max(1, max |plain|).  Then each autograd function on the card at
   a tiny shape: its kernel gradient against a central finite difference of
   its kernel forward along a random direction (float32 forward, so within
   1e-2 relative).
4. Serving: Matcher("outdoor_casmtr_4c", bucket=832) at full width on the
   card with seeded random weights answers three requests (textured images
   and shifted copies, one non-square).  The kernels' launch counts are
   zeroed just before and read just after; every kernel must have run.
5. Profile: one more steady request under torch.profiler (device busy
   share, device time by operator and by kernel).
6. Reference: the same full-width model at bucket 256 with its match
   thresholds at 0, on the card and on the CPU (plain versions), on one
   pair: coarse and window confidences and final matches must agree.
7. Training: train_step on outdoor_casmtr_4c at 704^2, batch 1, full width
   and depth, seeded random weights, on a pair whose image1 is a shifted
   crop of image0 with the matching camera translation.  One warm-up step
   and 4 timed steps, each with the launch counts zeroed just before and
   read just after (A 24 / A-bwd 24 / B 2 / B-bwd 1 / C 4 / C-bwd 4);
   finite losses, 1/4 matches to supervise, parameters that moved, nonzero
   finite gradients on the q/k/v projections that go through kernels A and
   C.  Then one more step under torch.profiler.
8. Training reference: one step of the full-width model at 256^2 on the
   card and on the CPU from the same weights and batch: loss within 1e-4
   relative, cosine of the whole flattened gradients >= 0.999.

The line before the last is one JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.  Exits non-zero, without those lines, when
CUDA is unavailable or any phase fails.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_TOL = 1e-4   # f32, another summation order than the plain version
CONF_TOL = 1e-4     # match confidences, card vs CPU (f32, TF32 off)
PX_TOL = 1e-2       # final keypoints in pixels, card vs CPU
MIN_JACCARD = 0.99  # final match sets, card vs CPU (near-ties may flip)
FD_EPS = 1e-3       # finite-difference step along a unit-variance direction
FD_TOL = 1e-2       # relative: the kernels' float32 outputs round at 1e-7
TRAIN_LOSS_RTOL = 1e-4   # one training step, card vs CPU
MIN_GRAD_COS = 0.999     # whole flattened gradient, card vs CPU
REFERENCE_S_PER_STEP = 1.19  # the reference's own GPU step (fp16), bench.py

# H100 SXM published peaks: HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores, at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

TPU_KERNELS = {
    "quadtree_fine_attention":
        "casmtr_tpu/ops/pallas/quadtree_kernels.py:118",
    "window_patch_score": "casmtr_tpu/ops/pallas/window_kernels.py:75",
    "window_cross_attention": "casmtr_tpu/ops/pallas/window_kernels.py:289",
    "quadtree_fine_attention_bwd":
        "casmtr_tpu/ops/pallas/quadtree_kernels.py:178",
    # plain XLA in the JAX package (the custom VJP of the Pallas kernel)
    "window_patch_score_bwd": "casmtr_tpu/ops/pallas/window_kernels.py:152",
    "window_cross_attention_bwd":
        "casmtr_tpu/ops/pallas/window_kernels.py:356",
}
SOURCES = {
    "quadtree_fine_attention": "casmtr_tpu_torch/csrc/quadtree_fine.cu",
    "window_patch_score": "casmtr_tpu_torch/csrc/window_score.cu",
    "window_cross_attention": "casmtr_tpu_torch/csrc/window_attention.cu",
    "quadtree_fine_attention_bwd":
        "casmtr_tpu_torch/csrc/quadtree_fine_bwd.cu",
    "window_patch_score_bwd": "casmtr_tpu_torch/csrc/window_score_bwd.cu",
    "window_cross_attention_bwd":
        "casmtr_tpu_torch/csrc/window_attention_bwd.cu",
}
# launches per image pair on the 4c eval path (no backward): 6 quadtree
# layers x 2 images x 2 fine levels; 2 score directions; 2 cross layers x 2
# images
LAUNCHES_PER_PAIR = {"quadtree_fine_attention": 24, "window_patch_score": 2,
                     "window_cross_attention": 4,
                     "quadtree_fine_attention_bwd": 0,
                     "window_patch_score_bwd": 0,
                     "window_cross_attention_bwd": 0}
# launches per training step (no rematerialization): the forward's, and one
# backward for each forward whose inputs need a gradient -- all but the
# detached 1->0 window scores
LAUNCHES_PER_TRAIN_STEP = dict(LAUNCHES_PER_PAIR,
                               quadtree_fine_attention_bwd=24,
                               window_patch_score_bwd=1,
                               window_cross_attention_bwd=4)
TRAIN_SIZE = 704
TRAIN_SHIFT = (16, 24)   # (dy, dx) pixels from image0 to image1
NO_LIBRARY = ("no single PyTorch call computes attention over gathered "
              "candidate sets, or its gradient")


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------

def time_ms(torch, fn, reps=25, warmup=3):
    """Median CUDA-event time of ``fn`` in ms; a 256 MB buffer is rewritten
    before each launch, so every launch starts with a cold 50 MB L2."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved, flops):
    """Least time on the card (ms) and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases 2 and 3: kernels against their plain versions
# --------------------------------------------------------------------------

def quadtree_inputs(torch, gen, g):
    """The 1/8 quadtree pyramid on a g x g finest grid (g^2, (g/2)^2, (g/4)^2
    grids, H=8, D=32, topks 32/16) from seeded features; the block ids of
    the two fine levels come from the real coarse-level top-k and the real
    intermediate-level selection."""
    from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
    from casmtr_tpu_torch.ops.quadtree import _coarse_level, _gather_select
    H, D, C = 8, 32, 256
    levels = []
    q, k, v = (torch.randn((1, C, g, g), generator=gen, device="cuda")
               for _ in range(3))
    for _ in range(3):
        toks = [t.flatten(2).transpose(1, 2).reshape(1, -1, H, D).contiguous()
                for t in (q, k, v)]
        levels.append((tuple(q.shape[-2:]), toks))
        q, k, v = avg_pool_2x2(q), avg_pool_2x2(k), avg_pool_2x2(v)
    (hw2, l2), (hw1, l1), (hw0, l0) = levels
    _, ids1 = _coarse_level(*l0, 32)
    ids2 = _gather_select(l1[0], l1[1], ids1, 16, hw1, hw1)
    return {f"intermediate {g // 2}x{g // 2}": (l1, ids1, hw1),
            f"finest {g}x{g}": (l2, ids2, hw2)}


def window_inputs(torch, gen, g2):
    """Window corners of the 1/4 cascade level (w = 5) whose 1/8 grid is
    g2 x g2: each 1/8 cell's match is a cell a few steps away (a shifted
    image pair), turned into boundary-shifted windows by window_warp_idx."""
    from casmtr_tpu_torch.models.cascade_transformer import window_warp_idx
    from casmtr_tpu_torch.ops.propagation import get_propagations
    yy, xx = torch.meshgrid(torch.arange(g2, device="cuda"),
                            torch.arange(g2, device="cuda"), indexing="ij")
    dy, dx = (torch.randint(-4, 5, (g2, g2), generator=gen, device="cuda")
              for _ in range(2))
    nxt = ((yy + dy).clamp(0, g2 - 1) * g2 + (xx + dx).clamp(0, g2 - 1))
    window, _ = get_propagations("window", 5)
    win = window_warp_idx(nxt.reshape(1, -1), window, g2, g2)
    return win[:, :, 0, :].to(torch.int32).contiguous()


def kernel_row(torch, rows, name, label, path, kernel, plain, inputs,
               bytes_moved, flops, scattered=()):
    """Hold ``kernel()`` against ``plain()`` (a tensor or a tuple of them),
    time both, and append the row.  Outputs whose index is in ``scattered``
    are sums of atomic adds: their tolerance scales with max |plain|."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"{name} [{label}] output {i}: shape {tuple(a.shape)} or "
              "non-finite")
        err = float((a - b).abs().max())
        tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                            if i in scattered else 1.0)
        errs.append((err, tol))
    t_kernel = time_ms(torch, kernel)
    t_plain = time_ms(torch, plain)
    t_bound, by = bound(bytes_moved, flops)
    err = max(e for e, _ in errs)
    log(f"kernel {name} [{label}] inputs {inputs}: max_abs_err "
        + ", ".join(f"{e:.3e} (tol {t:.3g})" for e, t in errs)
        + f", kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, bound "
        f"{t_bound:.4f} ms ({by}: {bytes_moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    for i, (e, t) in enumerate(errs):
        check(e <= t, f"{name} [{label}] output {i}: max abs error {e:.3e} "
              f"> {t:.3g}")
    rows.append({"name": name, "shape": label, "path": path, "route": "cuda",
                 "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                 "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                 "bound_ms": t_bound, "bound_by": by, "library_ms": None,
                 "library_note": NO_LIBRARY,
                 # max_err and kernel_ms repeat max_abs_err and ms
                 "max_err": err, "kernel_ms": t_kernel})


def attention_flops(n_tasks, n_cand, D, backward=False):
    """QK and PV over n_cand candidates for 4 child queries per task (2 FLOP
    per multiply-add); the backward recomputes QK and adds dP, dQ, dK and
    dV."""
    return n_tasks * (5 if backward else 2) * 2 * 4 * n_cand * D


def kernel_phase(torch):
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
        quadtree_fine_attention, quadtree_fine_attention_plain)
    from casmtr_tpu_torch.ops.kernels.window_kernels import (
        window_cross_attention, window_cross_attention_plain,
        window_patch_score, window_patch_score_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    path = "serving 832^2"

    # kernel A at both fine levels
    for label, ((q, k, v), ids, hw) in quadtree_inputs(torch, gen,
                                                       104).items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        kernel_row(
            torch, rows, "quadtree_fine_attention", label, path,
            lambda: quadtree_fine_attention(q, k, v, ids, hw, hw),
            lambda: quadtree_fine_attention_plain(q, k, v, ids, hw, hw),
            f"q/k/v {list(q.shape)} ids {list(ids.shape)}",
            nbytes(q, k, v, ids) + P * 4 * H * D * 4,
            attention_flops(P * H, 4 * K, D))

    # kernel B: window scores, C = 128, w = 5 on the 208^2 grid
    corners = window_inputs(torch, gen, 104)
    C, w = 128, 5
    P = corners.shape[1]
    q_blk = torch.randn((1, P, 4, C), generator=gen, device="cuda") * C ** -0.25
    feat1 = torch.randn((1, 208, 208, C), generator=gen,
                        device="cuda") * C ** -0.25
    kernel_row(torch, rows, "window_patch_score", "208x208 C=128 w=5", path,
               lambda: window_patch_score(q_blk, feat1, corners, w),
               lambda: window_patch_score_plain(q_blk, feat1, corners, w),
               f"q_blk {list(q_blk.shape)} feat1 {list(feat1.shape)} "
               f"corners {list(corners.shape)}",
               nbytes(q_blk, feat1, corners) + P * 4 * 4 * w * w * 4,
               P * 4 * 4 * w * w * C * 2)

    # kernel C: window cross-attention, H = 4, D = 32, w = 5 on 208^2
    H, D = 4, 32
    q, k, v = (torch.randn((1, 208 * 208, H, D), generator=gen, device="cuda")
               for _ in range(3))
    hw = (208, 208)
    kernel_row(torch, rows, "window_cross_attention", "208x208 H=4 D=32 w=5",
               path,
               lambda: window_cross_attention(q, k, v, corners, hw, hw, w),
               lambda: window_cross_attention_plain(q, k, v, corners, hw, hw,
                                                    w),
               f"q/k/v {list(q.shape)} corners {list(corners.shape)}",
               nbytes(q, k, v, corners) + P * 4 * H * D * 4,
               attention_flops(P * H, 4 * w * w, D))
    return rows


def train_kernel_phase(torch):
    """The kernels at the shapes of the 704^2 training step: kernels A and C
    with their log-sum-exp output (written when a gradient will be needed),
    and the three backward kernels, each against its plain version from the
    same forward output, log-sum-exp and a random cotangent."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk_
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    path = "train 704^2"
    g8 = TRAIN_SIZE // 8

    for label, ((q, k, v), ids, hw) in quadtree_inputs(torch, gen,
                                                       g8).items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        desc = f"q/k/v {list(q.shape)} ids {list(ids.shape)}"
        kernel_row(
            torch, rows, "quadtree_fine_attention", label + " with LSE", path,
            lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True),
            lambda: qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw,
                                                      with_lse=True),
            desc, nbytes(q, k, v, ids, out, lse),
            attention_flops(P * H, 4 * K, D))
        kernel_row(
            torch, rows, "quadtree_fine_attention_bwd", label, path,
            lambda: qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                    g, hw, hw),
            lambda: qk_.quadtree_fine_attention_bwd_plain(
                q, k, v, ids, out, lse, g, hw, hw),
            desc, nbytes(q, k, v, ids, out, lse, g) + 3 * nbytes(q),
            attention_flops(P * H, 4 * K, D, backward=True), scattered=(1, 2))

    corners = window_inputs(torch, gen, g8)
    g4 = TRAIN_SIZE // 4
    C, w = 128, 5
    P = corners.shape[1]
    NC = 4 * w * w
    q_blk = torch.randn((1, P, 4, C), generator=gen, device="cuda") * C ** -0.25
    feat1 = torch.randn((1, g4, g4, C), generator=gen,
                        device="cuda") * C ** -0.25
    g = torch.randn((1, P, 4, NC), generator=gen, device="cuda")
    kernel_row(torch, rows, "window_patch_score", f"{g4}x{g4} C={C} w={w}",
               path, lambda: wk_.window_patch_score(q_blk, feat1, corners, w),
               lambda: wk_.window_patch_score_plain(q_blk, feat1, corners, w),
               f"q_blk {list(q_blk.shape)} feat1 {list(feat1.shape)} "
               f"corners {list(corners.shape)}",
               nbytes(q_blk, feat1, corners, g), P * 2 * 4 * NC * C)
    kernel_row(torch, rows, "window_patch_score_bwd",
               f"{g4}x{g4} C={C} w={w}", path,
               lambda: wk_.window_patch_score_bwd(q_blk, feat1, corners, g, w),
               lambda: wk_.window_patch_score_bwd_plain(q_blk, feat1, corners,
                                                        g, w),
               f"q_blk {list(q_blk.shape)} feat1 {list(feat1.shape)} "
               f"corners {list(corners.shape)}",
               nbytes(q_blk, feat1, corners, g, q_blk, feat1),
               P * 2 * (2 * 4 * NC * C), scattered=(1,))

    H, D = 4, 32
    q, k, v = (torch.randn((1, g4 * g4, H, D), generator=gen, device="cuda")
               for _ in range(3))
    hw = (g4, g4)
    out, lse = (t.contiguous() for t in wk_.window_cross_attention_plain(
        q, k, v, corners, hw, hw, w, with_lse=True))
    g = torch.randn(out.shape, generator=gen, device="cuda")
    desc = f"q/k/v {list(q.shape)} corners {list(corners.shape)}"
    label = f"{g4}x{g4} H={H} D={D} w={w}"
    kernel_row(torch, rows, "window_cross_attention", label + " with LSE",
               path,
               lambda: wk_._launch_wca_fwd(q, k, v, corners, hw, hw, w, True),
               lambda: wk_.window_cross_attention_plain(q, k, v, corners, hw,
                                                        hw, w, with_lse=True),
               desc, nbytes(q, k, v, corners, out, lse),
               attention_flops(P * H, NC, D))
    kernel_row(torch, rows, "window_cross_attention_bwd", label, path,
               lambda: wk_.window_cross_attention_bwd(q, k, v, corners, out,
                                                      lse, g, hw, hw, w),
               lambda: wk_.window_cross_attention_bwd_plain(
                   q, k, v, corners, out, lse, g, hw, hw, w),
               desc, nbytes(q, k, v, corners, out, lse, g) + 3 * nbytes(q),
               attention_flops(P * H, NC, D, backward=True), scattered=(1, 2))
    return rows


def finite_difference_phase(torch):
    """Each autograd function on the card at a tiny shape: the gradient its
    backward kernel gives for sum(out * cot), along a random direction,
    against the central difference of its forward kernel (evaluated in
    float32, summed in float64)."""
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import \
        quadtree_fine_attention
    from casmtr_tpu_torch.ops.kernels.window_kernels import (
        window_cross_attention, window_patch_score)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    hw = (8, 12)
    cases = {
        # block ids may repeat within one (parent, head)
        "QuadtreeFineAttention": (
            lambda q, k, v, i: quadtree_fine_attention(q, k, v, i, hw, hw),
            [randn(1, 96, 2, 8) for _ in range(3)],
            [randint(24, 1, 24, 3, 2)]),
        "WindowPatchScore": (
            lambda q, f1, c: window_patch_score(q, f1, c, 2),
            [randn(1, 48, 4, 12), randn(1, 12, 16, 12)],
            [torch.stack([randint(5, 1, 48), randint(7, 1, 48)], -1)]),
        "WindowCrossAttention": (
            lambda q, k, v, c: window_cross_attention(q, k, v, c, (12, 12),
                                                      (12, 12), 2),
            [randn(1, 144, 2, 8) for _ in range(3)], [randint(5, 1, 36, 2)]),
    }
    for name, (fn, floats, ints) in cases.items():
        xs = [x.clone().requires_grad_(True) for x in floats]
        out = fn(*xs, *ints)
        cot = torch.randn(out.shape, generator=gen, device="cuda")
        (out * cot).sum().backward()
        errs = []
        for i, x in enumerate(xs):
            direction = torch.randn(x.shape, generator=gen, device="cuda")
            analytic = float((x.grad.double() * direction.double()).sum())

            def f(delta):
                args = list(floats)
                args[i] = floats[i] + delta * direction
                with torch.no_grad():
                    return float((fn(*args, *ints).double()
                                  * cot.double()).sum())

            fd = (f(FD_EPS) - f(-FD_EPS)) / (2 * FD_EPS)
            errs.append(abs(fd - analytic) / max(abs(analytic), 1e-3))
        log(f"finite difference: {name} on the card, relative error per "
            f"input " + ", ".join(f"{e:.2e}" for e in errs)
            + f" (tol {FD_TOL:g}, eps {FD_EPS:g})")
        check(max(errs) <= FD_TOL, f"finite difference: {name} gradient "
              "disagrees with its forward")


# --------------------------------------------------------------------------
# phase 4: serving through the Matcher
# --------------------------------------------------------------------------

def texture(rng, h, w):
    """A uint8 RGB scene: smooth gratings plus random blobs and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.01, 0.12, 2)
            img[..., c] += np.sin(fy * yy + fx * xx + rng.uniform(0, 6))
    for _ in range(60):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(4, 30)
        img += (rng.uniform(-1, 1, 3)
                * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2)[..., None])
    img += 0.1 * rng.standard_normal(img.shape)
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def requests(rng):
    """(name, image0, image1): a scene and a shifted or cropped copy."""
    out = []
    big = texture(rng, 900, 900)
    out.append(("832x832 shifted by (17, 9) px", big[:832, :832],
                big[17:849, 9:841]))
    big = texture(rng, 900, 900)
    out.append(("832x832 cropped to 768x768 (resized)", big[:832, :832],
                big[40:808, 30:798]))
    big = texture(rng, 700, 900)
    out.append(("600x800 non-square shifted by (11, 23) px", big[:600, :800],
                big[11:611, 23:823]))
    return out


def serving_phase(torch):
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.serving import Matcher
    t0 = time.perf_counter()
    matcher = Matcher("outdoor_casmtr_4c", bucket=832, seed=0)
    n_params = sum(p.numel() for p in matcher.model.parameters())
    log(f"serving: Matcher('outdoor_casmtr_4c', bucket=832) on "
        f"{matcher.device}, {n_params} parameters (seeded random), built in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests(np.random.default_rng(0))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for i, (name, img0, img1) in enumerate(reqs):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = matcher.match(img0, img1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        n = len(res.mconf)
        check(res.mkpts0.shape == (n, 2) and res.mkpts1.shape == (n, 2),
              "serving: result shapes")
        check(bool(np.isfinite(res.mkpts0).all() and
                   np.isfinite(res.mkpts1).all() and
                   np.isfinite(res.mconf).all()), "serving: non-finite result")
        h0, w0 = img0.shape[:2]
        check(n == 0 or (res.mkpts0.min() >= 0 and
                         res.mkpts0[:, 0].max() <= w0 and
                         res.mkpts0[:, 1].max() <= h0),
              "serving: keypoints outside image0")
        tag = "warm-up" if i == 0 else "steady"
        log(f"serving: request {i} ({tag}) {name}: {ms:.1f} ms, {n} matches "
            f"at thr {matcher.thr}, kernel launches {counts}")
        check(counts == LAUNCHES_PER_PAIR,
              f"serving: launches {counts}, expected {LAUNCHES_PER_PAIR}")
    totals = dict(kernels.LAUNCHES)
    log(f"serving: launches over the {len(reqs)} requests {totals}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for k, v in totals.items():
        check(v > 0 or LAUNCHES_PER_PAIR[k] == 0,
              f"serving: kernel {k} never launched on the main path")
    return totals, matcher, reqs[1]


def top(avgs, keep, n):
    """The n profiler rows that ``keep`` selects with the most self device
    time (ms, count, name, input shapes), and their summed time over all
    selected rows."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                    e.input_shapes) for e in avgs if keep(e)),
                  key=lambda r: -r[0])
    return rows[:n], sum(r[0] for r in rows)


def profile_phase(torch, matcher, request):
    """One more steady request under torch.profiler: device time summed over
    the request's kernels against its wall time, and device time by
    operator (the convolutions also by input shape) and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    name, img0, img1 = request
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        matcher.match(img0, img1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    avgs = prof.key_averages()
    kern, busy = top(avgs, lambda e: e.device_type == DeviceType.CUDA, 10)
    if busy == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    ops, _ = top(avgs, lambda e: e.key.startswith("aten::")
                 and e.self_device_time_total > 0, 10)
    convs, _ = top(prof.key_averages(group_by_input_shape=True),
                   lambda e: e.key == "aten::cudnn_convolution", 6)
    log(f"profile: request {name} under the profiler: wall {wall:.1f} ms, "
        f"device time summed over kernels {busy:.1f} ms")
    for ms, n, key, _ in ops:
        log(f"profile: op     {ms:8.3f} ms {n:5d}x {key}")
    for ms, n, key, shapes in convs:
        log(f"profile: conv   {ms:8.3f} ms {n:5d}x input, weight "
            f"{shapes[:2]}")
    for ms, n, key, _ in kern:
        log(f"profile: kernel {ms:8.3f} ms {n:5d}x {key[:80]}")
    conv_algorithm_ab()


# cuDNN caches the algorithm it first picks for a convolution's shapes,
# whatever mode picked it, so each mode is timed in a process of its own
CONV_PROBE = """
import statistics, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = sys.argv[1] == "1"
conv = torch.nn.Conv2d(256, 128, 3, padding=1, bias=False).cuda()
x = torch.randn(2, 256, 208, 208, device="cuda").contiguous(
    memory_format=torch.channels_last)
times = []
with torch.inference_mode():
    for i in range(6):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record(); conv(x); e.record(); torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
print(statistics.median(times[1:]))
"""


def conv_algorithm_ab():
    """The Twins FPN's 3x3 256->128 conv at its 832^2 input (2 images of
    256 x 208 x 208, channels-last as the FPN makes it): cuDNN's heuristic
    algorithm choice against its autotuner, each in a fresh process."""
    ms = {}
    for tuned in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", CONV_PROBE, tuned],
                             capture_output=True, text=True, check=True,
                             timeout=300)
        ms[tuned] = float(out.stdout.strip().splitlines()[-1])
    t_bound, by = bound((2 * 256 + 2 * 128) * 208 * 208 * 4
                        + 128 * 256 * 9 * 4, 2 * 208 * 208 * 128 * 256 * 9 * 2)
    log(f"profile: conv 3x3 256->128 on 2 x 256 x 208 x 208: cuDNN heuristic "
        f"{ms['0']:.3f} ms, autotuned {ms['1']:.3f} ms, bound {t_bound:.3f} "
        f"ms ({by})")


# --------------------------------------------------------------------------
# phase 6: the card against the CPU on a small input
# --------------------------------------------------------------------------

def reference_phase(torch):
    from casmtr_tpu_torch.serving import Matcher
    ov = {"loftr": {"match_coarse": {"thr": 0.0},
                    "match_cascade": {"test_thr": [0.0], "pre_thr": [[0.0]]}}}
    rng = np.random.default_rng(1)
    big = texture(rng, 300, 300)
    img0, img1 = big[:256, :256], big[7:263, 5:261]
    outs = {}
    for dev in ("cuda", "cpu"):
        m = Matcher("outdoor_casmtr_4c", bucket=256, thr=0.0, overrides=ov,
                    device=dev, seed=0)
        batch = m._pack([(img0, img1)])
        with torch.inference_mode():
            out = m.model(batch)
        outs[dev] = out
    gc, cc = outs["cuda"], outs["cpu"]
    conf_err = float((gc.coarse.conf_matrix.cpu()
                      - cc.coarse.conf_matrix).abs().max())
    cas_err = float((gc.cascades["4c"].conf_matrix.cpu()
                     - cc.cascades["4c"].conf_matrix).abs().max())

    def by_pair(fm):
        v = fm.valid.cpu().numpy()
        keys = zip(*(getattr(fm, n).cpu().numpy()[v]
                     for n in ("b_ids", "i_ids", "j_ids")))
        return {tuple(int(x) for x in k): i for i, k in
                enumerate(keys)}, fm.mkpts1.cpu().numpy()[v]

    kg, pg = by_pair(gc.final_matches)
    kc, pc = by_pair(cc.final_matches)
    common = kg.keys() & kc.keys()
    jac = len(common) / max(1, len(kg.keys() | kc.keys()))
    px_err = max((float(np.abs(pg[kg[k]] - pc[kc[k]]).max()) for k in common),
                 default=0.0)
    log(f"reference: bucket 256, thresholds 0, card vs CPU: coarse conf "
        f"max_abs_err {conf_err:.3e}, 1/4 window conf max_abs_err "
        f"{cas_err:.3e} (tol {CONF_TOL:g}); final matches "
        f"{len(kg)} vs {len(kc)}, Jaccard {jac:.4f} (min {MIN_JACCARD}); "
        f"mkpts1 max err on common {px_err:.3e} px (tol {PX_TOL:g})")
    check(len(kc) > 0, "reference: no final matches on the CPU")
    check(conf_err <= CONF_TOL, "reference: coarse confidences disagree")
    check(cas_err <= CONF_TOL, "reference: window confidences disagree")
    check(jac >= MIN_JACCARD, "reference: final match sets disagree")
    check(px_err <= PX_TOL, "reference: final keypoints disagree")


# --------------------------------------------------------------------------
# phases 7 and 8: training
# --------------------------------------------------------------------------

def train_batch(size, seed):
    """A batch of one pair as numpy arrays: image0 a textured scene, image1
    the same scene shifted by TRAIN_SHIFT (a crop of it), constant depth,
    focal length ``size`` and the camera translation that maps each pixel
    of image0 onto its shifted place in image1."""
    rng = np.random.default_rng(seed)
    dy, dx = TRAIN_SHIFT
    big = texture(rng, size + dy, size + dx).astype(np.float32) / 255.0
    depth, f = 5.0, float(size)
    K = np.array([[[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]]],
                 np.float32)
    T = np.eye(4, dtype=np.float32)[None].copy()
    T[0, 0, 3], T[0, 1, 3] = -dx * depth / f, -dy * depth / f
    return {"image0": big[None, :size, :size].copy(),
            "image1": big[None, dy:dy + size, dx:dx + size].copy(),
            "depth0": np.full((1, size, size), depth, np.float32),
            "depth1": np.full((1, size, size), depth, np.float32),
            "K0": K, "K1": K.copy(), "T_0to1": T,
            "T_1to0": np.linalg.inv(T[0])[None].astype(np.float32)}


def kernel_grad_params(model):
    """The q/k/v projections whose gradients go through kernels A-bwd (the
    six 1/8 quadtree layers) and C-bwd (the two 1/4 cross layers)."""
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in ("loftr_coarse_8c", "loftr_coarse_4c")
            and n.split(".")[-2] in ("q_proj", "k_proj", "v_proj")]


def build_trainer(torch, size, device=None, model=None):
    """outdoor_casmtr_4c at ``size`` with seeded random weights (or a copy
    of ``model``), its optimizer state and its step."""
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    cfg = build_config("outdoor_casmtr_4c",
                       overrides={"loftr": {"train_size": size}})
    if model is None:
        model = build_model(cfg.loftr)
        init_random_(model, torch.Generator().manual_seed(0))
    state, tx = init_train_state(model, cfg, steps_per_epoch=1000,
                                 base_lr=1e-3, device=device)
    return model, state, make_train_step(model, cfg, tx, device=device)


def training_phase(torch):
    from casmtr_tpu_torch.ops import kernels
    model, state, step = build_trainer(torch, TRAIN_SIZE)
    n_params = sum(p.numel() for p in model.parameters())
    watch = kernel_grad_params(model)
    check(len(watch) == 24, f"training: {len(watch)} kernel-path q/k/v "
          "projections, expected 24")
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in watch}
    batch = train_batch(TRAIN_SIZE, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, scalars = step(state, batch)
    torch.cuda.synchronize()
    log(f"training: outdoor_casmtr_4c {TRAIN_SIZE}^2 batch 1, {n_params} "
        f"parameters (seeded random), warm-up step "
        f"{time.perf_counter() - t0:.2f} s, loss {float(scalars['loss']):.4f}")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for i in range(4):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, scalars = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        vals = {k: float(v) for k, v in scalars.items()}
        log(f"training: step {i + 1}: {times[-1]:.4f} s, "
            + ", ".join(f"{k} {v:.4g}" for k, v in sorted(vals.items()))
            + f", kernel launches {counts}")
        check(all(np.isfinite(v) for v in vals.values()),
              "training: non-finite loss or gradient norm")
        check(vals["valid_n_4c"] > 0, "training: no 1/4 match to supervise")
        check(counts == LAUNCHES_PER_TRAIN_STEP,
              f"training: launches {counts}, expected "
              f"{LAUNCHES_PER_TRAIN_STEP}")
        for n in watch:
            g = params[n].grad
            check(g is not None and bool(torch.isfinite(g).all())
                  and float(g.abs().max()) > 0,
                  f"training: no finite nonzero gradient on {n}")
    totals = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(start[n], params[n].detach()) for n in watch)
    check(moved == len(watch), f"training: {len(watch) - moved} q/k/v "
          "projections did not move")
    for k, v in totals.items():
        check(v > 0, f"training: kernel {k} never launched on the main path")
    log(f"training: median {statistics.median(times):.4f} s/step over "
        f"{len(times)} steps, peak device memory {peak:.2f} GiB, launches "
        f"over the {len(times)} steps {totals}; the reference's own GPU "
        f"step, for context only: {REFERENCE_S_PER_STEP} s (fp16, bench.py)")
    return totals, step, state, batch, statistics.median(times)


def train_profile_phase(torch, step, state, batch, median_s):
    """One more training step under torch.profiler: device time summed over
    its kernels against its wall time (the host's and the idle share), and
    device time by operator and by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kern, busy = top(avgs, lambda e: e.device_type == DeviceType.CUDA, 12)
    if busy == 0:
        log("training profile: the profiler recorded no device time (not "
            "measured)")
        return
    ops, _ = top(avgs, lambda e: e.key.startswith("aten::")
                 and e.self_device_time_total > 0, 12)
    log(f"training profile: one step: wall {wall:.1f} ms under the "
        f"profiler, device time summed over kernels {busy:.1f} ms; idle "
        f"share {1 - busy / wall:.3f} of the profiled step, "
        f"{1 - busy / (median_s * 1e3):.3f} of the median unprofiled step")
    ours, ours_ms = top(avgs, lambda e: e.device_type == DeviceType.CUDA
                        and e.key.startswith("casmtr::"), 6)
    for ms, n, key, _ in ops:
        log(f"training profile: op     {ms:8.3f} ms {n:5d}x {key}")
    for ms, n, key, _ in kern:
        log(f"training profile: kernel {ms:8.3f} ms {n:5d}x {key[:80]}")
    for ms, n, key, _ in ours:
        log(f"training profile: ours   {ms:8.3f} ms {n:5d}x "
            f"{key.split('(')[0]}")
    log(f"training profile: the six CUDA kernels {ours_ms:.1f} ms of the "
        f"{busy:.1f} ms of device time")


def train_reference_phase(torch):
    """One step of the full-width model at 256^2 on the card and on the CPU
    (the kernels' plain versions) from the same weights and batch."""
    size = 256
    base, _, _ = build_trainer(torch, size, device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        model, state, step = build_trainer(torch, size, device=dev,
                                           model=copy.deepcopy(base))
        t0 = time.perf_counter()
        _, scalars = step(state, train_batch(size, 1))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().double().cpu() for n, p in model.named_parameters()}
        res[dev] = ({k: float(v) for k, v in scalars.items()}, grads,
                    time.perf_counter() - t0)
    (sg, gg, tg), (sc, gc, tc) = res["cuda"], res["cpu"]
    rel_loss = abs(sg["loss"] - sc["loss"]) / abs(sc["loss"])
    fg = torch.cat([gg[n].flatten() for n in gc])
    fc = torch.cat([gc[n].flatten() for n in gc])
    cos = float(fg @ fc / (fg.norm() * fc.norm()))
    # a leaf whose gradient vanishes analytically (a bias in front of a
    # training-mode BatchNorm) holds only rounding noise: floor its norm
    floor = 1e-3 * float(fc.norm())
    worst, worst_name = max(
        (float((gg[n] - gc[n]).norm()) / max(float(gc[n].norm()), floor), n)
        for n in gc)
    log(f"training reference: {size}^2, one step, card vs CPU: loss "
        f"{sg['loss']:.6f} vs {sc['loss']:.6f} (relative {rel_loss:.2e}, "
        f"tol {TRAIN_LOSS_RTOL:g}); valid_n_4c {sg['valid_n_4c']:.0f} vs "
        f"{sc['valid_n_4c']:.0f}; gradient cosine {cos:.6f} (min "
        f"{MIN_GRAD_COS}); worst per-leaf relative error {worst:.2e} "
        f"({worst_name}, not gated); step {tg:.2f} s on the card, {tc:.2f} s "
        f"on the CPU")
    check(rel_loss <= TRAIN_LOSS_RTOL, "training reference: losses disagree")
    check(cos >= MIN_GRAD_COS, "training reference: gradients disagree")


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import casmtr_tpu_torch  # noqa: F401  (fails outside the repository)
    from casmtr_tpu_torch.ops import kernels

    # full float32 everywhere the port compares numbers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    kernels.lib(fresh=True)
    log(f"build: nvcc {' '.join(kernels.NVCC_FLAGS)} of "
        f"{len(kernels.SOURCES)} sources, {kernels.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")
    for line in kernels.build_log().splitlines():
        if "Used" in line or "entry function" in line or "spill" in line:
            log(f"build: {line.strip()}")

    rows = timed("kernels", kernel_phase, torch)
    train_rows = timed("training kernels", train_kernel_phase, torch)
    timed("finite difference", finite_difference_phase, torch)
    totals, matcher, request = timed("serving", serving_phase, torch)
    for row in rows:
        row["launches"] = totals[row["name"]]
    timed("profile", profile_phase, torch, matcher, request)
    del matcher
    timed("reference", reference_phase, torch)
    torch.cuda.empty_cache()
    train_totals, step, state, batch, median_s = timed(
        "training", training_phase, torch)
    for row in train_rows:
        row["launches"] = train_totals[row["name"]]
        row["launches_per_step"] = LAUNCHES_PER_TRAIN_STEP[row["name"]]
    timed("training profile", train_profile_phase, torch, step, state, batch,
          median_s)
    del step, state
    torch.cuda.empty_cache()
    timed("training reference", train_reference_phase, torch)

    log(json.dumps({"kernels": rows + train_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
