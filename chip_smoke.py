#!/usr/bin/env python3
"""Smoke test of the PyTorch port (casmtr_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the CUDA kernels from csrc/ with nvcc.
2. Kernels: each CUDA kernel of the serving path against its plain PyTorch
   version on the card, at the shapes of the flagship outdoor_casmtr_4c eval
   at 832^2 with realistic indices (a real top-k, real window corners), in
   float32 with TF32 off; max abs error <= 1e-4.  Kernel and plain version
   are timed with CUDA events (median of 25 launches, L2 flushed before
   each), beside the least time the card needs for the same work.
3. Serving: Matcher("outdoor_casmtr_4c", bucket=832) at full width on the
   card with seeded random weights answers three requests (textured images
   and shifted copies, one non-square).  The kernels' launch counts are
   zeroed just before and read just after; every kernel must have run.
4. Profile: one more steady request under torch.profiler (device busy
   share, device time by operator and by kernel).
5. Reference: the same full-width model at bucket 256 with its match
   thresholds at 0, on the card and on the CPU (plain versions), on one
   pair: coarse and window confidences and final matches must agree.

The line before the last is one JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}.  Exits non-zero, without those lines, when
CUDA is unavailable or any phase fails.
"""

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

# H100 SXM published peaks: HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores, at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

TPU_KERNELS = {
    "quadtree_fine_attention":
        "casmtr_tpu/ops/pallas/quadtree_kernels.py:118",
    "window_patch_score": "casmtr_tpu/ops/pallas/window_kernels.py:75",
    "window_cross_attention": "casmtr_tpu/ops/pallas/window_kernels.py:289",
}
SOURCES = {
    "quadtree_fine_attention": "casmtr_tpu_torch/csrc/quadtree_fine.cu",
    "window_patch_score": "casmtr_tpu_torch/csrc/window_score.cu",
    "window_cross_attention": "casmtr_tpu_torch/csrc/window_attention.cu",
}
# launches per image pair on the 4c eval path: 6 quadtree layers x 2
# images x 2 fine levels; 2 score directions; 2 cross layers x 2 images
LAUNCHES_PER_PAIR = {"quadtree_fine_attention": 24, "window_patch_score": 2,
                     "window_cross_attention": 4}


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
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def quadtree_inputs(torch, gen):
    """The 1/8 quadtree pyramid of the 832^2 eval (104^2, 52^2, 26^2 grids,
    H=8, D=32, topks 32/16) from seeded features; the block ids of the two
    fine levels come from the real coarse-level top-k and the real
    intermediate-level selection."""
    from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
    from casmtr_tpu_torch.ops.quadtree import _coarse_level, _gather_select
    H, D, C = 8, 32, 256
    levels = []
    q, k, v = (torch.randn((1, C, 104, 104), generator=gen, device="cuda")
               for _ in range(3))
    for _ in range(3):
        toks = [t.flatten(2).transpose(1, 2).reshape(1, -1, H, D).contiguous()
                for t in (q, k, v)]
        levels.append((tuple(q.shape[-2:]), toks))
        q, k, v = avg_pool_2x2(q), avg_pool_2x2(k), avg_pool_2x2(v)
    (hw2, l2), (hw1, l1), (hw0, l0) = levels
    _, ids1 = _coarse_level(*l0, 32)                       # [1, 676, 32, 8]
    ids2 = _gather_select(l1[0], l1[1], ids1, 16, hw1, hw1)  # [1,2704,16,8]
    return {"intermediate 52x52": (l1, ids1, hw1),
            "finest 104x104": (l2, ids2, hw2)}


def window_inputs(torch, gen):
    """Window corners of the 1/4 cascade level at 832^2 (w = 5): each 1/8
    cell's match is a cell a few steps away (a shifted image pair), turned
    into boundary-shifted windows by window_warp_idx."""
    from casmtr_tpu_torch.models.cascade_transformer import window_warp_idx
    from casmtr_tpu_torch.ops.propagation import get_propagations
    g2 = 104
    yy, xx = torch.meshgrid(torch.arange(g2, device="cuda"),
                            torch.arange(g2, device="cuda"), indexing="ij")
    dy, dx = (torch.randint(-4, 5, (g2, g2), generator=gen, device="cuda")
              for _ in range(2))
    nxt = ((yy + dy).clamp(0, g2 - 1) * g2 + (xx + dx).clamp(0, g2 - 1))
    window, _ = get_propagations("window", 5)
    win = window_warp_idx(nxt.reshape(1, -1), window, g2, g2)
    return win[:, :, 0, :].to(torch.int32).contiguous()


def kernel_phase(torch):
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
        quadtree_fine_attention, quadtree_fine_attention_plain)
    from casmtr_tpu_torch.ops.kernels.window_kernels import (
        window_cross_attention, window_cross_attention_plain,
        window_patch_score, window_patch_score_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def run(name, label, kernel, plain, inputs, bytes_moved, flops):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} [{label}]: shape {tuple(got.shape)} or non-finite")
        err = float((got - want).abs().max())
        t_kernel = time_ms(torch, kernel)
        t_plain = time_ms(torch, plain)
        t_bound, by = bound(bytes_moved, flops)
        log(f"kernel {name} [{label}] inputs {inputs}: max_abs_err {err:.3e} "
            f"(tol {KERNEL_TOL:g}), kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.4f} ms, bound {t_bound:.4f} ms ({by}: "
            f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        check(err <= KERNEL_TOL, f"{name} [{label}]: max abs error {err:.3e} "
              f"> {KERNEL_TOL:g}")
        rows.append({"name": name, "shape": label, "route": "cuda",
                     "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                     "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
                     "bound_ms": t_bound, "bound_by": by,
                     "library_ms": None,
                     # max_err and kernel_ms repeat max_abs_err and ms
                     "max_err": err, "kernel_ms": t_kernel})

    # kernel A at both fine levels
    for label, ((q, k, v), ids, hw) in quadtree_inputs(torch, gen).items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        out_bytes = P * 4 * H * D * 4
        run("quadtree_fine_attention", label,
            lambda: quadtree_fine_attention(q, k, v, ids, hw, hw),
            lambda: quadtree_fine_attention_plain(q, k, v, ids, hw, hw),
            f"q/k/v {list(q.shape)} ids {list(ids.shape)}",
            nbytes(q, k, v, ids) + out_bytes,
            P * H * 2 * (2 * 4 * 4 * K * D))   # QK and PV, 2 FLOP per MAC

    # kernel B: window scores, C = 128, w = 5 on the 208^2 grid
    corners = window_inputs(torch, gen)
    C, w = 128, 5
    P = corners.shape[1]
    q_blk = torch.randn((1, P, 4, C), generator=gen, device="cuda") * C ** -0.25
    feat1 = torch.randn((1, 208, 208, C), generator=gen,
                        device="cuda") * C ** -0.25
    run("window_patch_score", "208x208 C=128 w=5",
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
    run("window_cross_attention", "208x208 H=4 D=32 w=5",
        lambda: window_cross_attention(q, k, v, corners, hw, hw, w),
        lambda: window_cross_attention_plain(q, k, v, corners, hw, hw, w),
        f"q/k/v {list(q.shape)} corners {list(corners.shape)}",
        nbytes(q, k, v, corners) + P * 4 * H * D * 4,
        P * H * 2 * (2 * 4 * 4 * w * w * D))
    return rows


# --------------------------------------------------------------------------
# phase 3: serving through the Matcher
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
        check(v > 0, f"serving: kernel {k} never launched on the main path")
    return totals, matcher, reqs[1]


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

    def top(avgs, keep, n):
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                        e.input_shapes) for e in avgs if keep(e)),
                      key=lambda r: -r[0])
        return rows[:n], sum(r[0] for r in rows)

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
# phase 5: the card against the CPU on a small input
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

    rows = kernel_phase(torch)
    totals, matcher, request = serving_phase(torch)
    for row in rows:
        row["launches"] = totals[row["name"]]
    profile_phase(torch, matcher, request)
    del matcher
    reference_phase(torch)

    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
