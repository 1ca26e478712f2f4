#!/usr/bin/env python3
"""Smoke test of the PyTorch port (casmtr_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It drives both ported recipes, outdoor_casmtr_4c and outdoor_casmtr_2c, at
full width.  Phases, each printing its own lines and its seconds:

1. Environment: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the build of the CUDA kernels from csrc/ with nvcc.
2. Kernels: each CUDA kernel of the serving path against its plain PyTorch
   version on the card, at the shapes of the 832^2 eval with realistic
   indices (a real top-k, real window corners), in float32 with TF32 off:
   A at the finest 104^2 level (and at 52^2, beside A′), A′ at the
   intermediate 52^2 level (K = 32, top 16), B and C at the 1/4 level
   (208^2, C=128, H=4) and at 2c's 1/2 level (416^2, C=64, H=2); max abs
   error <= 1e-4.  A′ is held to its plain version by message (and LSE)
   within 1e-4, sorted top-k scores within 1e-5, equal index sets wherever
   the plain version's k-th and (k+1)-th scores are more than 1e-5 apart
   (near ties counted and printed), and the next level's message from both
   index sets within 1e-4 on those rows; A′ also on rows that hold a NaN
   (no fault, the NaN passed on, the other rows as the plain version).
   Kernel and plain version are timed with CUDA events (median of 25
   launches, L2 flushed before each, the card held busy while the host
   enqueues the call), beside the least time the card needs
   for the same work and a library yardstick, one PyTorch call on inputs
   gathered beforehand (gather not timed; checked against the plain
   version first): scaled_dot_product_attention, pinned to its
   memory-efficient backend (float32), over the gathered windows for A and
   C, torch.matmul against the gathered patch for B; A′ also beside the
   unfused route (kernel A plus a plain top-k selection).
3. Training kernels: the same at the shapes of the 704^2 training step for
   the forward kernels with their log-sum-exp output and for the three
   backward kernels (A-bwd at 88^2 and 44^2; B, B-bwd, C and C-bwd at 176^2
   and at 2c's 352^2; the yardstick of A-bwd and C-bwd is the backward of
   the forward's).  dq within 1e-4; the atomically summed dk, dv and
   dfeat1 within 1e-4 x max(1, max |plain|).  C and C-bwd also at 176^2 on
   corners whose patches run past the grid edge or are negative (the flat
   clipped-gather rule), against the plain versions, and through their
   public wrappers on tiny cases that take every instance of the two
   kernels (WINDOW_CASES: other H and D, misaligned inputs, w = 1, a batch
   of two); likewise A, A′ and A-bwd through their public wrappers and
   launchers (QUADTREE_CASES: other H and D, misaligned inputs, K = 1,
   n_topk 1 and 4K, repeated ids, ids outside the block grid, a batch of
   two).  Then each autograd
   function on the card at a tiny shape: its kernel gradient against a
   central finite difference of its kernel forward along a random
   direction (float32 forward, so within 1e-2 relative).
4. Serving: Matcher(recipe, bucket=832) at full width on the card with
   seeded random weights answers three requests (textured images and
   shifted copies, one non-square), for 4c and then 2c.  The kernels'
   launch counts are zeroed just before each recipe's requests and read
   after each request; each must match the recipe's count per pair.
5. Profile: one more steady request of each recipe under torch.profiler
   (device busy share, device time by operator and by kernel).
6. Reference: each full-width recipe at bucket 256 with its match
   thresholds at 0, on the card and on the CPU (plain versions), on one
   pair: coarse and window confidences and final matches must agree.
7. Training: train_step on each recipe at 704^2, batch 1, full width and
   depth, seeded random weights, on a pair whose image1 is a shifted crop
   of image0 with the matching camera translation.  One warm-up step and
   4 timed steps, each with the launch counts zeroed just before and read
   just after; finite losses, matches to supervise at every cascade level,
   parameters that moved, nonzero finite gradients on the q/k/v
   projections that go through kernels A, A′ and C.  Then one more step
   under torch.profiler.
8. Training reference: one step of each full-width recipe at 256^2 on the
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
SCORE_TOL = 1e-5    # A′'s top-k probabilities, sorted
TIE_GAP = 1e-5      # A′ rows whose k-th and (k+1)-th scores are this close
                    # may select either candidate: excluded from the index
                    # checks, and counted
CONF_TOL = 1e-4     # match confidences, card vs CPU (f32, TF32 off)
PX_TOL = 1e-2       # final keypoints in pixels, card vs CPU
MIN_JACCARD = 0.99  # final match sets, card vs CPU (near-ties may flip)
FD_EPS = 1e-3       # finite-difference step along a unit-variance direction
FD_TOL = 1e-2       # relative: the kernels' float32 outputs round at 1e-7
TRAIN_LOSS_RTOL = 1e-4   # one training step, card vs CPU
MIN_GRAD_COS = 0.999     # whole flattened gradient, card vs CPU
REFERENCE_S_PER_STEP = 1.19  # the reference's own 4c GPU step (fp16), bench.py

HOLD_CYCLES = 1_000_000  # about 0.5 ms of the card's clock: longer than the
                         # host takes to enqueue one kernel wrapper

# H100 SXM published peaks: HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores, at the full 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

RECIPES = ("outdoor_casmtr_4c", "outdoor_casmtr_2c")
TPU_KERNELS = {
    "quadtree_fine_attention":
        "casmtr_tpu/ops/pallas/quadtree_kernels.py:118",
    # the same body with n_topk > 0; its pallas_call
    "quadtree_fine_topk": "casmtr_tpu/ops/pallas/quadtree_kernels.py:321",
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
    "quadtree_fine_topk": "casmtr_tpu_torch/csrc/quadtree_fine.cu",
    "window_patch_score": "casmtr_tpu_torch/csrc/window_score.cu",
    "window_cross_attention": "casmtr_tpu_torch/csrc/window_attention.cu",
    "quadtree_fine_attention_bwd":
        "casmtr_tpu_torch/csrc/quadtree_fine_bwd.cu",
    "window_patch_score_bwd": "casmtr_tpu_torch/csrc/window_score_bwd.cu",
    "window_cross_attention_bwd":
        "casmtr_tpu_torch/csrc/window_attention_bwd.cu",
}


def per_pair(n_levels):
    """Launches per image pair on the eval path (no backward): 6 quadtree
    layers x 2 images, each running A′ at the intermediate and A at the
    finest 1/8 level; per cascade level 2 window-score directions and 2
    cross layers x 2 images."""
    return {"quadtree_fine_attention": 12, "quadtree_fine_topk": 12,
            "window_patch_score": 2 * n_levels,
            "window_cross_attention": 4 * n_levels,
            "quadtree_fine_attention_bwd": 0, "window_patch_score_bwd": 0,
            "window_cross_attention_bwd": 0}


def per_step(n_levels):
    """Launches per training step (no rematerialization): the forward's,
    and one backward for each forward whose inputs need a gradient -- all
    but the detached 1->0 window scores; A and A′ share A-bwd."""
    return dict(per_pair(n_levels), quadtree_fine_attention_bwd=24,
                window_patch_score_bwd=n_levels,
                window_cross_attention_bwd=4 * n_levels)


LAUNCHES_PER_PAIR = {"outdoor_casmtr_4c": per_pair(1),
                     "outdoor_casmtr_2c": per_pair(2)}
LAUNCHES_PER_TRAIN_STEP = {"outdoor_casmtr_4c": per_step(1),
                           "outdoor_casmtr_2c": per_step(2)}
TRAIN_SIZE = 704
TRAIN_SHIFT = (16, 24)   # (dy, dx) pixels from image0 to image1
# The library yardstick of each row: one PyTorch call on inputs gathered
# beforehand (the gather is not timed).  scaled_dot_product_attention takes
# float32 only in its memory-efficient and math backends; it is pinned to
# the first.  The port never calls any of these.
SDPA_BACKEND = "EFFICIENT_ATTENTION"
SDPA_NOTE = ("torch.nn.functional.scaled_dot_product_attention (backend "
             f"{SDPA_BACKEND}) over the candidate windows gathered "
             "beforehand, one batch row per {rows}; gather not timed")
LIBRARY_NOTES = {
    "quadtree_fine_attention": SDPA_NOTE.format(rows="(parent, head)"),
    "window_cross_attention": SDPA_NOTE.format(rows="parent"),
    "quadtree_fine_attention_bwd":
        "backward of the row's forward yardstick (torch.autograd.grad of "
        "the same call), dq and the gathered rows' dk, dv; gather not "
        "timed, and no scatter of dk, dv back onto the key grid",
    "window_patch_score": "torch.matmul of the 2x2-blocked queries against "
                          "the patch rows gathered beforehand; gather not "
                          "timed",
    "quadtree_fine_topk": "null: no PyTorch call fuses a top-k selection "
                          "into attention; unfused_ms holds kernel A plus "
                          "the plain selection",
    "window_patch_score_bwd": "null: dq (a product with the gathered patch) "
                              "and dfeat1 (a scatter-add) need two calls",
}
LIBRARY_NOTES["window_cross_attention_bwd"] = \
    LIBRARY_NOTES["quadtree_fine_attention_bwd"]
LSE_NOTE = "; the message only: the public call returns no log-sum-exp"


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
    before each launch, so every launch starts with a cold 50 MB L2.  The
    card then spins for HOLD_CYCLES before the start event, so the host's
    time to enqueue ``fn`` (Python, argument checks, autograd) passes
    during the spin and not between the events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
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
    intermediate-level selection.  Returns {label: ((q, k, v), ids, hw)}
    for the intermediate and the finest level."""
    from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import \
        quadtree_fine_topk_plain
    from casmtr_tpu_torch.ops.quadtree import _coarse_level
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
    ids2 = quadtree_fine_topk_plain(*l1, ids1, hw1, hw1, 16)[2].contiguous()
    return {f"intermediate {g // 2}x{g // 2}": (l1, ids1, hw1),
            f"finest {g}x{g}": (l2, ids2, hw2)}


def window_inputs(torch, gen, g2):
    """Window corners of a cascade level (w = 5) whose previous grid is
    g2 x g2: each previous cell's match is a cell a few steps away (a
    shifted image pair), turned into boundary-shifted windows by
    window_warp_idx."""
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
               bytes_moved, flops, scattered=(), library=None, note=""):
    """Hold ``kernel()`` against ``plain()`` (a tensor or a tuple of them),
    time both and ``library()`` (the row's library yardstick, a callable
    returning its time in ms, or None), and append the row.  Outputs whose
    index is in ``scattered`` are sums of atomic adds: their tolerance
    scales with max |plain|.  ``note`` is added to the library note."""
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
    t_library = library() if library is not None else None
    t_bound, by = bound(bytes_moved, flops)
    err = max(e for e, _ in errs)
    log(f"kernel {name} [{label}] inputs {inputs}: max_abs_err "
        + ", ".join(f"{e:.3e} (tol {t:.3g})" for e, t in errs)
        + f", kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, library "
        + ("null" if t_library is None else f"{t_library:.4f} ms")
        + f", bound {t_bound:.4f} ms ({by}: {bytes_moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    for i, (e, t) in enumerate(errs):
        check(e <= t, f"{name} [{label}] output {i}: max abs error {e:.3e} "
              f"> {t:.3g}")
    return add_row(rows, name, label, path, err, t_kernel, t_plain, t_bound,
                   by, t_library, note)


def add_row(rows, name, label, path, err, t_kernel, t_plain, t_bound, by,
            t_library=None, note=""):
    row = {"name": name, "shape": label, "path": path, "route": "cuda",
           "source": SOURCES[name], "replaces": TPU_KERNELS[name],
           "max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
           "bound_ms": t_bound, "bound_by": by, "library_ms": t_library,
           "library_note": LIBRARY_NOTES[name] + note,
           # max_err and kernel_ms repeat max_abs_err and ms
           "max_err": err, "kernel_ms": t_kernel}
    rows.append(row)
    return row


def sdpa_library(torch, qb, k_g, v_g, want, g=None):
    """The library yardstick of an attention row: a callable that times
    ``scaled_dot_product_attention`` (backend SDPA_BACKEND) on gathered
    queries qb [N, h, 4, D] and candidates k_g/v_g [N, h, C, D] -- with the
    cotangent ``g`` its backward alone, ``torch.autograd.grad`` of the same
    call.  Its forward output is first held against ``want`` (the plain
    message laid out as qb)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = getattr(SDPBackend, SDPA_BACKEND)

    def run():
        with sdpa_kernel(backend):
            if g is None:
                return time_ms(torch, lambda: sdpa(qb, k_g, v_g))
            xs = [t.detach().requires_grad_(True) for t in (qb, k_g, v_g)]
            out = sdpa(*xs)
            return time_ms(torch, lambda: torch.autograd.grad(
                out, xs, g, retain_graph=True))

    with sdpa_kernel(backend):
        err = float((sdpa(qb, k_g, v_g) - want).abs().max())
    check(err <= KERNEL_TOL, f"library yardstick: {SDPA_BACKEND} differs "
          f"from the plain message by {err:.3e}")
    return run


def window_library(torch, q, k, v, corners, hw, w, with_grad):
    """C's (or with ``with_grad`` C-bwd's) library yardstick: the patch
    candidates gathered as in the plain version, laid out [B*P, H, C, D]."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    from casmtr_tpu_torch.ops.quadtree import block_children
    B, _, H, D = q.shape
    idx = kernels.clip_index(wk._expand_corner_indices(corners, w, hw[1]),
                             hw[0] * hw[1])
    bi = torch.arange(B, device=q.device)[:, None, None]

    def heads_first(t):          # [B, P, n, H, D] -> [B*P, H, n, D]
        return t.permute(0, 1, 3, 2, 4).flatten(0, 1).contiguous()

    k_g, v_g = heads_first(k[bi, idx]), heads_first(v[bi, idx])
    qb = heads_first(block_children(q, *hw))
    want = heads_first(wk.window_cross_attention_plain(q, k, v, corners, hw,
                                                       hw, w))
    g = (torch.randn(qb.shape, device=q.device) if with_grad else None)
    return sdpa_library(torch, qb, k_g, v_g, want, g)


def quadtree_library(torch, q, k, v, ids, hw, with_grad):
    """A's (or A-bwd's) library yardstick: each (parent, head)'s 4K
    candidates gathered as in the plain version, [B*P*H, 1, 4K, D]."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    from casmtr_tpu_torch.ops.quadtree import block_children
    B, _, H, D = q.shape
    P, K = ids.shape[1:3]
    k_g, v_g, _ = qk_._candidates(k, v, ids, hw)        # [B, P, K, H, 4, D]

    def rows(t):
        return t.permute(0, 1, 3, 2, 4, 5).reshape(B * P * H, 1, 4 * K, D)

    def queries(t):             # [B, P, 4, H, D] -> [B*P*H, 1, 4, D]
        return t.permute(0, 1, 3, 2, 4).reshape(B * P * H, 1, 4, D)

    qb = queries(block_children(q, *hw)).contiguous()
    want = queries(qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw))
    g = (torch.randn(qb.shape, device=q.device) if with_grad else None)
    return sdpa_library(torch, qb, rows(k_g).contiguous(),
                        rows(v_g).contiguous(), want, g)


def attention_flops(n_tasks, n_cand, D, backward=False):
    """QK and PV over n_cand candidates for 4 child queries per task (2 FLOP
    per multiply-add); the backward recomputes QK and adds dP, dQ, dK and
    dV."""
    return n_tasks * (5 if backward else 2) * 2 * 4 * n_cand * D


def unfused_selection(torch, q, k, ids, hw, topk):
    """The intermediate level's top-k selection without kernel A′, in plain
    torch beside kernel A: gather the candidate keys again, recompute the
    scores, softmax, top-k, map to key-grid positions [B, Lq, topk, H]."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.quadtree import (block_children,
                                               to_block_major,
                                               unblock_children)
    h, w = hw
    B, _, H, D = q.shape
    K = ids.shape[2]
    qb = block_children(q, h, w)
    P = qb.shape[1]
    table = to_block_major(k, h, w)
    blk_ids = kernels.clip_index(ids.long(), table.shape[1])
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, None, None, :]
    k_g = table[bi, blk_ids, hi].reshape(B, P, K, H, 4, D)
    qk = torch.einsum("bpfhd,bpkhjd->bpfhkj", qb, k_g)
    qk = qk.reshape(B, P, 4, H, 4 * K) * (D ** -0.5)
    _, local = torch.topk(torch.softmax(qk, dim=-1), topk, dim=-1)
    ids_bh = blk_ids.transpose(2, 3)[:, :, None].expand(B, P, 4, H, K)
    blk = torch.gather(ids_bh, 4, local // 4)
    child = local % 4
    rows = (blk // (w // 2)) * 2 + child // 2
    cols = (blk % (w // 2)) * 2 + child % 2
    return unblock_children((rows * w + cols).transpose(3, 4), h // 2,
                            w // 2).to(torch.int32)


def selection_errors(torch, score, idx, p_score, p_idx, topk, rows):
    """A′'s selection against the plain version's top (topk + 1) on the
    child rows ``rows`` [B, Lq, H] (bool): max abs error of the sorted
    scores, the rows whose index sets differ although the plain version's
    k-th and (k+1)-th scores are more than TIE_GAP apart, the near-tie rows
    excluded from that check, and the plain version's top-k indices."""
    s_got = score.sort(dim=2, descending=True).values
    s_err = float(torch.where(rows[:, :, None],
                              (s_got - p_score[:, :, :topk]).abs(), 0).max())
    p_top = p_idx[:, :, :topk].contiguous()
    clear = rows & ((p_score[:, :, topk - 1] - p_score[:, :, topk])
                    > TIE_GAP)
    same = (idx.sort(dim=2).values == p_top.sort(dim=2).values).all(dim=2)
    return (s_err, int((clear & ~same).sum()), int((rows & ~clear).sum()),
            clear, p_top)


def topk_row(torch, rows, label, path, inter, finest, topk, with_lse):
    """Kernel A′ at the intermediate level ``inter`` against its plain
    version: through its public wrapper ``quadtree_fine_topk`` (serving), or
    with ``with_lse`` (training) through ``QuadtreeFineAttention`` with a
    gradient to come, which writes the log-sum-exp (read back through the
    launcher).  The next level's message is read from the ``finest``
    level's q/k/v.  Times the call beside its plain version, its bound and
    the unfused route (kernel A and ``unfused_selection``)."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    (q, k, v), ids, hw = inter
    (qn, kn, vn), _, hw_n = finest
    B, Lq, H, D = q.shape
    P, K = ids.shape[1:3]
    NC = 4 * K

    def kernel():
        if with_lse:
            return qk_.QuadtreeFineAttention.apply(q, k, v, ids, hw, hw, True,
                                                   topk)
        return qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)

    msg, score, idx = kernel()
    p_msg, p_score, p_idx, p_lse = qk_.quadtree_fine_topk_plain(
        q, k, v, ids, hw, hw, topk + 1, with_lse=True)
    outs = [("message", msg, p_msg)]
    lse = None
    if with_lse:
        lse = qk_._launch_fwd(q, k, v, ids, hw, hw, True, topk)[1]
        outs.append(("lse", lse, p_lse))
    torch.cuda.synchronize()
    for what, a, b in outs + [("score", score, p_score[:, :, :topk])]:
        check(a.shape == b.shape and bool(torch.isfinite(a).all()),
              f"quadtree_fine_topk [{label}] {what}: shape "
              f"{tuple(a.shape)} or non-finite")
    errs = {what: float((a - b).abs().max()) for what, a, b in outs}
    everywhere = torch.ones((B, Lq, H), dtype=torch.bool, device="cuda")
    errs["score"], idx_bad, excluded, clear, p_top = selection_errors(
        torch, score, idx, p_score, p_idx, topk, everywhere)
    nxt = [qk_.quadtree_fine_attention_plain(qn, kn, vn, i, hw_n, hw_n)
           for i in (idx, p_top)]
    nxt_err = float(((nxt[0] - nxt[1]).abs()
                     * clear[:, :, None, :, None]).max())
    t_kernel = time_ms(torch, kernel)
    t_plain = time_ms(torch, lambda: qk_.quadtree_fine_topk_plain(
        q, k, v, ids, hw, hw, topk, with_lse))
    t_unfused = time_ms(torch, lambda: (
        qk_._launch_fwd(q, k, v, ids, hw, hw, with_lse),
        unfused_selection(torch, q, k, ids, hw, topk)))
    bytes_moved = nbytes(q, k, v, ids, msg, score, idx) + (
        nbytes(lse) if with_lse else 0)
    # the attention, and the selection at its least: one compare per
    # candidate of each of the 4 child rows
    flops = attention_flops(P * H, NC, D) + P * H * 4 * NC
    t_bound, by = bound(bytes_moved, flops)
    log(f"kernel quadtree_fine_topk [{label}] q/k/v {list(q.shape)} ids "
        f"{list(ids.shape)} top {topk}: max_abs_err "
        + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
        + f" (tol {KERNEL_TOL:g}, score {SCORE_TOL:g}); index sets differ "
        f"on {idx_bad} of {B * Lq * H} rows, {excluded} rows excluded as "
        f"near ties (gap <= {TIE_GAP:g}); next level's message "
        f"max_abs_err {nxt_err:.3e}; kernel {t_kernel:.4f} ms, plain "
        f"{t_plain:.4f} ms, unfused (kernel A + plain selection) "
        f"{t_unfused:.4f} ms, bound {t_bound:.4f} ms ({by}: "
        f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
    for what, e in errs.items():
        check(e <= (SCORE_TOL if what == "score" else KERNEL_TOL),
              f"quadtree_fine_topk [{label}] {what}: max abs error {e:.3e}")
    check(idx_bad == 0, f"quadtree_fine_topk [{label}]: {idx_bad} rows "
          "select other indices")
    check(nxt_err <= KERNEL_TOL, f"quadtree_fine_topk [{label}]: next "
          f"level's message max abs error {nxt_err:.3e}")
    row = add_row(rows, "quadtree_fine_topk", label, path,
                  max(errs.values()), t_kernel, t_plain, t_bound, by)
    row.update(near_tie_rows_excluded=excluded, unfused_ms=t_unfused)


def topk_nan_check(torch, gen):
    """Kernel A′ on child rows whose scores hold a NaN (one NaN query row:
    all of its scores; one NaN key row: one score of every row that reads
    it).  The launch must not fault.  Rows without a NaN agree with the
    plain version; rows with one have NaN scores and in-range indices, as
    the plain version passes the NaN on; the all-NaN row selects its first
    ``topk`` candidates (a NaN ranks above every number, ties go to the
    lower candidate)."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    hw, H, D, K, topk = (8, 12), 2, 8, 4, 6
    Lq, n_blk = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)
    q, k, v = (torch.randn((1, Lq, H, D), generator=gen, device="cuda")
               for _ in range(3))
    ids = torch.randint(0, n_blk, (1, n_blk, K, H), generator=gen,
                        device="cuda", dtype=torch.int32)
    q[0, 13, 1] = float("nan")   # child 3 of parent 0, head 1
    k[0, 40, 0] = float("nan")
    msg, score, idx = qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)
    torch.cuda.synchronize()
    p_msg, p_score, p_idx = qk_.quadtree_fine_topk_plain(q, k, v, ids, hw, hw,
                                                         topk + 1)
    nan_rows = torch.isnan(p_score).any(dim=2)
    fin = ~nan_rows
    s_err, idx_bad, _, _, _ = selection_errors(torch, score, idx, p_score,
                                               p_idx, topk, fin)
    msg_nan = torch.isnan(msg)
    msg_err = float((msg - p_msg).abs()[~msg_nan].max())
    first = qk_._candidates(k, v, ids, hw)[2][0, 0, 1, :topk].int()
    n_nan = int(nan_rows.sum())
    log(f"kernel quadtree_fine_topk [NaN rows] q/k/v {list(q.shape)} ids "
        f"{list(ids.shape)} top {topk}: {n_nan} of {nan_rows.numel()} rows "
        f"hold a NaN; on the others score max_abs_err {s_err:.3e}, index "
        f"sets differ on {idx_bad}, message max_abs_err {msg_err:.3e}; the "
        f"all-NaN row selects {idx[0, 13, :, 1].tolist()} (its first "
        f"candidates {first.tolist()})")
    check(0 < n_nan < nan_rows.numel(), "NaN check: no row or every row "
          "holds a NaN")
    check(torch.equal(msg_nan, torch.isnan(p_msg)),
          "NaN check: the message's NaNs differ from the plain version's")
    check(torch.equal(torch.isnan(score).all(dim=2), nan_rows)
          and torch.equal(torch.isfinite(score).all(dim=2), fin),
          "NaN check: NaN scores not where the plain version has them")
    check(bool(((idx >= 0) & (idx < Lq)).all()),
          "NaN check: index outside the key grid")
    check(s_err <= SCORE_TOL and idx_bad == 0 and msg_err <= KERNEL_TOL,
          "NaN check: rows without a NaN disagree with the plain version")
    check(torch.equal(idx[0, 13, :, 1], first),
          "NaN check: the all-NaN row does not select in candidate order")


def score_library(torch, q_blk, feat1, corners, w):
    """B's library yardstick: torch.matmul of q_blk [B, P, 4, C] against
    the patch rows [B, P, 4w^2, C] gathered beforehand."""
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    B, H1, W1, C = feat1.shape
    idx = kernels.clip_index(wk._expand_corner_indices(corners, w, W1),
                             H1 * W1)
    f1_g = feat1.reshape(B, H1 * W1, C)[
        torch.arange(B, device=feat1.device)[:, None, None], idx]
    f1_t = f1_g.transpose(-1, -2)
    err = float((torch.matmul(q_blk, f1_t) - wk.window_patch_score_plain(
        q_blk, feat1, corners, w)).abs().max())
    check(err <= KERNEL_TOL, f"library yardstick: matmul differs from the "
          f"plain scores by {err:.3e}")
    return lambda: time_ms(torch, lambda: torch.matmul(q_blk, f1_t))


def edge_corners(torch, gen, corners, g2):
    """A copy of ``corners`` (on a g2 x g2 half grid) whose patches leave
    the grid: a quarter of the parents take corners from [-3, g2 + 3), and
    four take (-1, -1), (g2 - 1, g2 - 1), (0, g2) and (-P, 3) -- a flat
    index below -n, which the clipped-gather rule clamps to row 0."""
    out = corners.clone()
    P = corners.shape[1]
    pick = torch.randperm(P, generator=gen, device="cuda")[:P // 4]
    out[0, pick] = torch.randint(-3, g2 + 3, (len(pick), 2), generator=gen,
                                 device="cuda", dtype=torch.int32)
    out[0, :4] = torch.tensor([[-1, -1], [g2 - 1, g2 - 1], [0, g2],
                               [-P, 3]], dtype=torch.int32)
    return out


def window_edge_check(torch, gen, q, k, v, corners, hw, w):
    """Kernels C (with its log-sum-exp) and C-bwd at the training shapes on
    corners whose patches run past the grid edge or are negative, against
    the plain versions: the flat clipped-gather rule on the card."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    edge = edge_corners(torch, gen, corners, hw[0] // 2)
    out, lse = wk._launch_wca_fwd(q, k, v, edge, hw, hw, w, True)
    p_out, p_lse = wk.window_cross_attention_plain(q, k, v, edge, hw, hw, w,
                                                   with_lse=True)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    got = wk.window_cross_attention_bwd(q, k, v, edge, out, lse, g, hw, hw, w)
    want = wk.window_cross_attention_bwd_plain(
        q, k, v, edge, p_out.contiguous(), p_lse.contiguous(), g, hw, hw, w)
    torch.cuda.synchronize()
    errs = {"message": float((out - p_out).abs().max()),
            "lse": float((lse - p_lse).abs().max())}
    tols = {"message": KERNEL_TOL, "lse": KERNEL_TOL}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[name] = float((a - b).abs().max())
        tols[name] = KERNEL_TOL * (1.0 if name == "dq"
                                   else max(1.0, float(b.abs().max())))
    log(f"kernel window_cross_attention(_bwd) [{hw[0]}x{hw[1]} edge corners, "
        f"y {int(edge[..., 0].min())}..{int(edge[..., 0].max())}, x "
        f"{int(edge[..., 1].min())}..{int(edge[..., 1].max())}]: max_abs_err "
        + ", ".join(f"{n} {e:.3e} (tol {tols[n]:.3g})"
                    for n, e in errs.items()))
    for n, e in errs.items():
        check(e <= tols[n], f"window_cross_attention edge corners: {n} max "
              f"abs error {e:.3e}")


def offset_randn(torch, gen, offset, shape):
    """A contiguous normal tensor on the card, 4 bytes off 16-byte alignment
    when ``offset``."""
    n = int(np.prod(shape)) + int(offset)
    return torch.randn(n, generator=gen, device="cuda")[int(offset):].view(
        shape)


# (B, H, D, grid, w, corners past the edge, inputs 4 bytes off 16-byte
# alignment).  Kernels C and C-bwd are instantiated for 16- or 4-byte copies
# (H*D % 4, alignment), float4 or float columns (D % 4) and one or four
# columns per thread (rows of more than 128 columns); these cases take all
# eight, and chunks cut short (rows of 2048 floats), w = 1 and a batch of two.
WINDOW_CASES = (
    (1, 3, 5, 12, 3, True, False),      # 4-byte copies, float columns
    (1, 2, 6, 12, 2, False, False),     # 16-byte copies, float columns
    (1, 4, 32, 16, 5, False, True),     # 4-byte copies, float4 columns
    (1, 4, 32, 24, 5, True, False),     # 16-byte, float4: the main paths'
    (1, 1, 64, 8, 1, False, False),     # w = 1, 4 candidates
    (1, 8, 256, 4, 1, True, False),     # 16-byte, float4, four per thread
    (1, 3, 45, 8, 2, True, False),      # 4-byte, float, four per thread
    (1, 40, 6, 8, 2, True, False),      # 16-byte, float, four per thread
    (1, 4, 160, 8, 2, True, True),      # 4-byte, float4, four per thread
    (2, 2, 32, 12, 5, True, False))     # a batch of two


def window_cases_check(torch):
    """Kernels C (with and without its log-sum-exp) and C-bwd through their
    public wrappers on WINDOW_CASES, against the plain versions."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    gen = torch.Generator(device="cuda").manual_seed(4)
    for B, H, D, grid, w, edge, offset in WINDOW_CASES:
        L, half, hw = grid * grid, grid // 2, (grid, grid)

        def randn(*shape):
            return offset_randn(torch, gen, offset, shape)

        q, k, v = (randn(B, L, H, D) for _ in range(3))
        lo, hi = (-2, half - w + 3) if edge else (0, half - w + 1)
        corners = torch.randint(lo, hi, (B, L // 4, 2), generator=gen,
                                device="cuda", dtype=torch.int32)
        if edge:
            corners[0, :4] = torch.tensor([[-1, -1], [half - 1, half - 1],
                                           [0, half], [-L, 3]])
        out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
            q, k, v, corners, hw, hw, w, with_lse=True))
        g = randn(*out.shape)
        want = (out, out, lse) + wk.window_cross_attention_bwd_plain(
            q, k, v, corners, out, lse, g, hw, hw, w)
        got = ((wk.window_cross_attention(q, k, v, corners, hw, hw, w),)
               + wk._launch_wca_fwd(q, k, v, corners, hw, hw, w, True)
               + wk.window_cross_attention_bwd(q, k, v, corners, out, lse, g,
                                               hw, hw, w))
        torch.cuda.synchronize()
        names = ("message", "message with LSE", "lse", "dq", "dk", "dv")
        errs = {}
        for n, a, b in zip(names, got, want):
            tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                                if n in ("dk", "dv") else 1.0)
            errs[n] = (float((a - b).abs().max()), tol)
        log(f"kernel window_cross_attention(_bwd) [B={B} H={H} D={D} "
            f"{grid}x{grid} w={w}" + (" edge corners" if edge else "")
            + (" misaligned" if offset else "") + "]: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items()))
        for n, (e, tol) in errs.items():
            check(e <= tol, f"window_cross_attention B={B} H={H} D={D} "
                  f"grid={grid} w={w}: {n} max abs error {e:.3e} > {tol:.3g}")


# (B, H, D, grid, K, ids, n_topk, inputs 4 bytes off 16-byte alignment).
# Kernels A and A′ (one body, with and without the selection) and A-bwd are
# instantiated for 16- or 4-byte copies (16 only when D % 4 == 0 and the
# inputs are aligned), float4 or float columns (D % 4) and one or four
# columns per thread (rows of more than 128 columns); these cases take all
# six instances of each, K = 1, n_topk 1 and 4K, repeated ids, ids below 0
# and past the block grid (the clipped-gather rule) and a batch of two.
QUADTREE_CASES = (
    (1, 2, 8, (8, 12), 3, "repeated", 1, False),   # 16-byte, float4
    (1, 4, 32, (8, 8), 4, "distinct", 16, True),   # 4-byte copies, float4
    (1, 3, 5, (8, 12), 3, "clip", 12, False),      # 4-byte, float; all 4K
    (1, 8, 80, (4, 8), 2, "repeated", 3, False),   # 16-byte, float4, four
    (1, 8, 80, (4, 8), 2, "clip", 8, True),        # 4-byte, float4, four
    (1, 6, 30, (8, 8), 2, "distinct", 5, False),   # 4-byte, float, four
    (1, 2, 8, (8, 8), 1, "clip", 4, False),        # K = 1: 4 candidates
    (1, 8, 12, (8, 8), 16, "repeated", 16, False),  # the finest K, D = 12
    (2, 8, 32, (8, 12), 5, "clip", 7, False))      # a batch of two


def quadtree_cases_check(torch):
    """Kernels A (through its public wrapper, and with its log-sum-exp
    through the launcher), A′ (public wrapper) and A-bwd on
    QUADTREE_CASES, against the plain versions; A′'s selection as in
    phase 2 (every candidate when n_topk = 4K)."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, H, D, hw, K, kind, topk, offset in QUADTREE_CASES:
        L, n_blk = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)

        def randn(*shape):
            return offset_randn(torch, gen, offset, shape)

        q, k, v = (randn(B, L, H, D) for _ in range(3))
        if kind == "distinct":
            ids = torch.argsort(torch.rand((B, n_blk, n_blk, H), generator=gen,
                                           device="cuda"), dim=2)[:, :, :K]
        else:
            lo, hi = (0, n_blk) if kind == "repeated" else (-n_blk - 3,
                                                           n_blk + 3)
            ids = torch.randint(lo, hi, (B, n_blk, K, H), generator=gen,
                                device="cuda")
            if kind == "repeated":
                ids[0, 0, :, 0] = ids[0, 0, 0, 0]
            else:
                ids[0, 0, :3, 0] = torch.tensor([-1, -2 * n_blk, n_blk])[:K]
        ids = ids.to(torch.int32).contiguous()
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = randn(*out.shape)
        want = (out, out, lse) + qk_.quadtree_fine_attention_bwd_plain(
            q, k, v, ids, out, lse, g, hw, hw)
        got = ((qk_.quadtree_fine_attention(q, k, v, ids, hw, hw),)
               + qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2]
               + qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse, g,
                                                 hw, hw))
        msg, score, idx = qk_.quadtree_fine_topk(q, k, v, ids, hw, hw, topk)
        p_msg, p_score, p_idx = qk_.quadtree_fine_topk_plain(
            q, k, v, ids, hw, hw, min(topk + 1, 4 * K))
        torch.cuda.synchronize()
        names = ("message", "message with LSE", "lse", "dq", "dk", "dv")
        errs = {}
        for n, a, b in zip(names, got, want):
            tol = KERNEL_TOL * (max(1.0, float(b.abs().max()))
                                if n in ("dk", "dv") else 1.0)
            errs[n] = (float((a - b).abs().max()), tol)
        errs["A′ message"] = (float((msg - p_msg).abs().max()), KERNEL_TOL)
        if topk < 4 * K:
            everywhere = torch.ones((B, L, H), dtype=torch.bool,
                                    device="cuda")
            s_err, idx_bad, _, _, _ = selection_errors(
                torch, score, idx, p_score, p_idx, topk, everywhere)
        else:   # every candidate: the same scores and positions
            s_err = float((score - p_score).abs().max())
            idx_bad = int((idx.sort(dim=2).values
                           != p_idx.sort(dim=2).values).any(dim=2).sum())
        errs["A′ score"] = (s_err, SCORE_TOL)
        log(f"kernel quadtree_fine_attention(_topk, _bwd) [B={B} H={H} D={D} "
            f"{hw[0]}x{hw[1]} K={K} {kind} ids top {topk}"
            + (" misaligned" if offset else "") + "]: max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, (e, _) in errs.items())
            + f"; A′ index sets differ on {idx_bad} rows")
        for n, (e, tol) in errs.items():
            check(e <= tol, f"quadtree B={B} H={H} D={D} grid={hw} K={K} "
                  f"{kind}: {n} max abs error {e:.3e} > {tol:.3g}")
        check(idx_bad == 0, f"quadtree B={B} H={H} D={D} grid={hw} K={K} "
              f"{kind}: A′ selects other indices on {idx_bad} rows")


def window_rows(torch, rows, gen, path, grid, C, H, train):
    """Kernels B and C on a grid x grid cascade level (w = 5; window scores
    over C channels, cross-attention with H heads of 32); for training with
    C's log-sum-exp output, and B-bwd and C-bwd."""
    from casmtr_tpu_torch.ops.kernels import window_kernels as wk
    corners = window_inputs(torch, gen, grid // 2)
    w, D = 5, 32
    P = corners.shape[1]
    NC = 4 * w * w
    q_blk = torch.randn((1, P, 4, C), generator=gen, device="cuda") * C ** -0.25
    feat1 = torch.randn((1, grid, grid, C), generator=gen,
                        device="cuda") * C ** -0.25
    label = f"{grid}x{grid} C={C} w={w}"
    desc = (f"q_blk {list(q_blk.shape)} feat1 {list(feat1.shape)} "
            f"corners {list(corners.shape)}")
    if not train:
        kernel_row(torch, rows, "window_patch_score", label, path,
                   lambda: wk.window_patch_score(q_blk, feat1, corners, w),
                   lambda: wk.window_patch_score_plain(q_blk, feat1,
                                                          corners, w),
                   desc, nbytes(q_blk, feat1, corners) + P * 4 * NC * 4,
                   P * 4 * NC * C * 2,
                   library=score_library(torch, q_blk, feat1, corners, w))
    else:
        g = torch.randn((1, P, 4, NC), generator=gen, device="cuda")
        kernel_row(torch, rows, "window_patch_score", label, path,
                   lambda: wk.window_patch_score(q_blk, feat1, corners, w),
                   lambda: wk.window_patch_score_plain(q_blk, feat1,
                                                          corners, w),
                   desc, nbytes(q_blk, feat1, corners, g), P * 2 * 4 * NC * C,
                   library=score_library(torch, q_blk, feat1, corners, w))
        kernel_row(torch, rows, "window_patch_score_bwd", label, path,
                   lambda: wk.window_patch_score_bwd(q_blk, feat1,
                                                        corners, g, w),
                   lambda: wk.window_patch_score_bwd_plain(
                       q_blk, feat1, corners, g, w),
                   desc, nbytes(q_blk, feat1, corners, g, q_blk, feat1),
                   P * 2 * (2 * 4 * NC * C), scattered=(1,))

    q, k, v = (torch.randn((1, grid * grid, H, D), generator=gen,
                           device="cuda") for _ in range(3))
    hw = (grid, grid)
    desc = f"q/k/v {list(q.shape)} corners {list(corners.shape)}"
    label = f"{grid}x{grid} H={H} D={D} w={w}"
    if not train:
        kernel_row(torch, rows, "window_cross_attention", label, path,
                   lambda: wk.window_cross_attention(q, k, v, corners, hw,
                                                        hw, w),
                   lambda: wk.window_cross_attention_plain(
                       q, k, v, corners, hw, hw, w),
                   desc, nbytes(q, k, v, corners) + P * 4 * H * D * 4,
                   attention_flops(P * H, NC, D),
                   library=window_library(torch, q, k, v, corners, hw, w,
                                          False))
        return
    out, lse = (t.contiguous() for t in wk.window_cross_attention_plain(
        q, k, v, corners, hw, hw, w, with_lse=True))
    g = torch.randn(out.shape, generator=gen, device="cuda")
    kernel_row(torch, rows, "window_cross_attention", label + " with LSE",
               path,
               lambda: wk._launch_wca_fwd(q, k, v, corners, hw, hw, w,
                                             True),
               lambda: wk.window_cross_attention_plain(
                   q, k, v, corners, hw, hw, w, with_lse=True),
               desc, nbytes(q, k, v, corners, out, lse),
               attention_flops(P * H, NC, D),
               library=window_library(torch, q, k, v, corners, hw, w, False),
               note=LSE_NOTE)
    kernel_row(torch, rows, "window_cross_attention_bwd", label, path,
               lambda: wk.window_cross_attention_bwd(
                   q, k, v, corners, out, lse, g, hw, hw, w),
               lambda: wk.window_cross_attention_bwd_plain(
                   q, k, v, corners, out, lse, g, hw, hw, w),
               desc, nbytes(q, k, v, corners, out, lse, g) + 3 * nbytes(q),
               attention_flops(P * H, NC, D, backward=True), scattered=(1, 2),
               library=window_library(torch, q, k, v, corners, hw, w, True))
    if grid == TRAIN_SIZE // 4:
        window_edge_check(torch, gen, q, k, v, corners, hw, w)


def kernel_phase(torch):
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
        quadtree_fine_attention, quadtree_fine_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    path = "serving 832^2"

    # kernel A at both fine levels (on the main path at the finest only)
    levels = quadtree_inputs(torch, gen, 104)
    for label, ((q, k, v), ids, hw) in levels.items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        kernel_row(
            torch, rows, "quadtree_fine_attention", label, path,
            lambda: quadtree_fine_attention(q, k, v, ids, hw, hw),
            lambda: quadtree_fine_attention_plain(q, k, v, ids, hw, hw),
            f"q/k/v {list(q.shape)} ids {list(ids.shape)}",
            nbytes(q, k, v, ids) + P * 4 * H * D * 4,
            attention_flops(P * H, 4 * K, D),
            library=quadtree_library(torch, q, k, v, ids, hw, False))
    # kernel A′ at the intermediate level, top 16 of 128 candidates
    inter, finest = levels.values()
    topk_row(torch, rows, "intermediate 52x52", path, inter, finest, 16,
             False)
    topk_nan_check(torch, gen)

    # kernels B and C at the 1/4 level, and at 2c's 1/2 level
    window_rows(torch, rows, gen, path, 208, 128, 4, False)
    window_rows(torch, rows, gen, path + " (2c)", 416, 64, 2, False)
    return rows


def train_kernel_phase(torch):
    """The kernels at the shapes of the 704^2 training step: kernels A, A′
    and C with their log-sum-exp output (written when a gradient will be
    needed), and the three backward kernels, each against its plain version
    from the same forward output, log-sum-exp and a random cotangent."""
    from casmtr_tpu_torch.ops.kernels import quadtree_kernels as qk_
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    path = "train 704^2"
    g8 = TRAIN_SIZE // 8

    levels = quadtree_inputs(torch, gen, g8)
    for label, ((q, k, v), ids, hw) in levels.items():
        P, K, H, D = ids.shape[1], ids.shape[2], q.shape[2], q.shape[3]
        out, lse = (t.contiguous() for t in qk_.quadtree_fine_attention_plain(
            q, k, v, ids, hw, hw, with_lse=True))
        g = torch.randn(out.shape, generator=gen, device="cuda")
        desc = f"q/k/v {list(q.shape)} ids {list(ids.shape)}"
        kernel_row(
            torch, rows, "quadtree_fine_attention", label + " with LSE", path,
            lambda: qk_._launch_fwd(q, k, v, ids, hw, hw, True)[:2],
            lambda: qk_.quadtree_fine_attention_plain(q, k, v, ids, hw, hw,
                                                      with_lse=True),
            desc, nbytes(q, k, v, ids, out, lse),
            attention_flops(P * H, 4 * K, D),
            library=quadtree_library(torch, q, k, v, ids, hw, False),
            note=LSE_NOTE)
        kernel_row(
            torch, rows, "quadtree_fine_attention_bwd", label, path,
            lambda: qk_.quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                    g, hw, hw),
            lambda: qk_.quadtree_fine_attention_bwd_plain(
                q, k, v, ids, out, lse, g, hw, hw),
            desc, nbytes(q, k, v, ids, out, lse, g) + 3 * nbytes(q),
            attention_flops(P * H, 4 * K, D, backward=True), scattered=(1, 2),
            library=quadtree_library(torch, q, k, v, ids, hw, True))
    inter, finest = levels.values()
    topk_row(torch, rows, f"intermediate {g8 // 2}x{g8 // 2} with LSE", path,
             inter, finest, 16, True)

    window_rows(torch, rows, gen, path, TRAIN_SIZE // 4, 128, 4, True)
    window_rows(torch, rows, gen, path + " (2c)", TRAIN_SIZE // 2, 64, 2,
                True)
    window_cases_check(torch)
    quadtree_cases_check(torch)
    return rows


def finite_difference_phase(torch):
    """Each autograd function on the card at a tiny shape: the gradient its
    backward kernel gives for sum(out * cot), along a random direction,
    against the central difference of its forward kernel (evaluated in
    float32, summed in float64)."""
    from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
        quadtree_fine_attention, quadtree_fine_topk)
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
        # the message of kernel A′ (its selection carries no gradient)
        "QuadtreeFineAttention with topk": (
            lambda q, k, v, i: quadtree_fine_topk(q, k, v, i, hw, hw, 4)[0],
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


def serving_phase(torch, recipe):
    from casmtr_tpu_torch.ops import kernels
    from casmtr_tpu_torch.serving import Matcher
    t0 = time.perf_counter()
    matcher = Matcher(recipe, bucket=832, seed=0)
    n_params = sum(p.numel() for p in matcher.model.parameters())
    expected = LAUNCHES_PER_PAIR[recipe]
    log(f"serving: Matcher('{recipe}', bucket=832) on "
        f"{matcher.device}, {n_params} parameters (seeded random), built in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = requests(np.random.default_rng(0))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    steady = []
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
        if i:
            steady.append(ms)
        log(f"serving: {recipe} request {i} ({tag}) {name}: {ms:.1f} ms, {n} "
            f"matches at thr {matcher.thr}, kernel launches {counts}")
        check(counts == expected,
              f"serving: {recipe} launches {counts}, expected {expected}")
    totals = dict(kernels.LAUNCHES)
    log(f"serving: {recipe} launches over the {len(reqs)} requests {totals}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for k, v in totals.items():
        check(v > 0 or expected[k] == 0,
              f"serving: {recipe}: kernel {k} never launched on the main path")
    return totals, counts, matcher, reqs[1], steady


def top(avgs, keep, n):
    """The n profiler rows that ``keep`` selects with the most self device
    time (ms, count, name, input shapes), and their summed time over all
    selected rows."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                    e.input_shapes) for e in avgs if keep(e)),
                  key=lambda r: -r[0])
    return rows[:n], sum(r[0] for r in rows)


def profile_phase(torch, recipe, matcher, request, conv_ab=False):
    """One more steady request under torch.profiler: device time summed over
    the request's kernels against its wall time, and device time by
    operator (the convolutions also by input shape) and by kernel; with
    ``conv_ab`` also the FPN conv's cuDNN algorithm choices."""
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
    ours, ours_ms = top(avgs, lambda e: e.device_type == DeviceType.CUDA
                        and "casmtr::" in e.key, 7)
    log(f"profile: {recipe} request {name} under the profiler: wall "
        f"{wall:.1f} ms, device time summed over kernels {busy:.1f} ms, of "
        f"which the CUDA kernels of this port {ours_ms:.1f} ms")
    for ms, n, key, _ in ops:
        log(f"profile: op     {ms:8.3f} ms {n:5d}x {key}")
    for ms, n, key, shapes in convs:
        log(f"profile: conv   {ms:8.3f} ms {n:5d}x input, weight "
            f"{shapes[:2]}")
    for ms, n, key, _ in kern:
        log(f"profile: kernel {ms:8.3f} ms {n:5d}x {key[:80]}")
    for ms, n, key, _ in ours:
        log(f"profile: ours   {ms:8.3f} ms {n:5d}x {key.split('(')[0]}")
    if conv_ab:
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

def zero_threshold_overrides(recipe):
    """Every match threshold of the recipe at 0, so every stage matches."""
    n = 2 if recipe.endswith("2c") else 1
    return {"loftr": {"match_coarse": {"thr": 0.0}, "match_cascade": {
        "test_thr": [0.0] * n,
        "pre_thr": [[0.0] * (i + 1) for i in range(n)]}}}


def reference_phase(torch, recipe):
    from casmtr_tpu_torch.serving import Matcher
    rng = np.random.default_rng(1)
    big = texture(rng, 300, 300)
    img0, img1 = big[:256, :256], big[7:263, 5:261]
    outs = {}
    for dev in ("cuda", "cpu"):
        m = Matcher(recipe, bucket=256, thr=0.0,
                    overrides=zero_threshold_overrides(recipe), device=dev,
                    seed=0)
        batch = m._pack([(img0, img1)])
        with torch.inference_mode():
            out = m.model(batch)
        outs[dev] = out
    gc, cc = outs["cuda"], outs["cpu"]
    conf_err = float((gc.coarse.conf_matrix.cpu()
                      - cc.coarse.conf_matrix).abs().max())
    cas_err = {lvl: float((gc.cascades[lvl].conf_matrix.cpu()
                           - cc.cascades[lvl].conf_matrix).abs().max())
               for lvl in cc.cascades}

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
    log(f"reference: {recipe} bucket 256, thresholds 0, card vs CPU: coarse "
        f"conf max_abs_err {conf_err:.3e}, window conf max_abs_err "
        + ", ".join(f"{lvl} {e:.3e}" for lvl, e in cas_err.items())
        + f" (tol {CONF_TOL:g}); final matches {len(kg)} vs {len(kc)}, "
        f"Jaccard {jac:.4f} (min {MIN_JACCARD}); mkpts1 max err on common "
        f"{px_err:.3e} px (tol {PX_TOL:g})")
    check(len(kc) > 0, "reference: no final matches on the CPU")
    check(conf_err <= CONF_TOL, "reference: coarse confidences disagree")
    check(max(cas_err.values()) <= CONF_TOL,
          "reference: window confidences disagree")
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
    """The q/k/v projections whose gradients go through kernel A-bwd (the
    six 1/8 quadtree layers, kernels A and A′) and C-bwd (the two cross
    layers of each cascade level)."""
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in ("loftr_coarse_8c", "loftr_coarse_4c",
                                   "loftr_coarse_2c")
            and n.split(".")[-2] in ("q_proj", "k_proj", "v_proj")]


def build_trainer(torch, recipe, size, device=None, model=None):
    """``recipe`` at ``size`` with seeded random weights (or a copy of
    ``model``), its optimizer state and its step."""
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    cfg = build_config(recipe, overrides={"loftr": {"train_size": size}})
    if model is None:
        model = build_model(cfg.loftr)
        init_random_(model, torch.Generator().manual_seed(0))
    state, tx = init_train_state(model, cfg, steps_per_epoch=1000,
                                 base_lr=1e-3, device=device)
    return model, state, make_train_step(model, cfg, tx, device=device)


def training_phase(torch, recipe):
    from casmtr_tpu_torch.ops import kernels
    model, state, step = build_trainer(torch, recipe, TRAIN_SIZE)
    levels = [f"{lvl}c" for lvl in model.config.cascade_levels]
    expected = LAUNCHES_PER_TRAIN_STEP[recipe]
    n_params = sum(p.numel() for p in model.parameters())
    watch = kernel_grad_params(model)
    n_watch = 18 + 6 * len(levels)
    check(len(watch) == n_watch, f"training: {len(watch)} kernel-path q/k/v "
          f"projections, expected {n_watch}")
    params = dict(model.named_parameters())
    start = {n: params[n].detach().clone() for n in watch}
    batch = train_batch(TRAIN_SIZE, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, scalars = step(state, batch)
    torch.cuda.synchronize()
    log(f"training: {recipe} {TRAIN_SIZE}^2 batch 1, {n_params} "
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
        log(f"training: {recipe} step {i + 1}: {times[-1]:.4f} s, "
            + ", ".join(f"{k} {v:.4g}" for k, v in sorted(vals.items()))
            + f", kernel launches {counts}")
        check(all(np.isfinite(v) for v in vals.values()),
              "training: non-finite loss or gradient norm")
        for lvl in levels:
            check(vals[f"valid_n_{lvl}"] > 0,
                  f"training: no {lvl} match to supervise")
        check(counts == expected,
              f"training: {recipe} launches {counts}, expected {expected}")
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
    log(f"training: {recipe} median {statistics.median(times):.4f} s/step "
        f"over {len(times)} steps, peak device memory {peak:.2f} GiB, "
        f"launches over the {len(times)} steps {totals}"
        + ("; the reference's own 4c GPU step, for context only: "
           f"{REFERENCE_S_PER_STEP} s (fp16, bench.py)"
           if len(levels) == 1 else ""))
    return totals, counts, step, state, batch, times


def train_profile_phase(torch, recipe, step, state, batch, median_s):
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
    log(f"training profile: {recipe} one step: wall {wall:.1f} ms under the "
        f"profiler, device time summed over kernels {busy:.1f} ms; idle "
        f"share {1 - busy / wall:.3f} of the profiled step, "
        f"{1 - busy / (median_s * 1e3):.3f} of the median unprofiled step")
    ours, ours_ms = top(avgs, lambda e: e.device_type == DeviceType.CUDA
                        and "casmtr::" in e.key, 7)
    for ms, n, key, _ in ops:
        log(f"training profile: op     {ms:8.3f} ms {n:5d}x {key}")
    for ms, n, key, _ in kern:
        log(f"training profile: kernel {ms:8.3f} ms {n:5d}x {key[:80]}")
    for ms, n, key, _ in ours:
        log(f"training profile: ours   {ms:8.3f} ms {n:5d}x "
            f"{key.split('(')[0]}")
    log(f"training profile: the port's CUDA kernels {ours_ms:.1f} ms of the "
        f"{busy:.1f} ms of device time")


def train_reference_phase(torch, recipe):
    """One step of the full-width model at 256^2 on the card and on the CPU
    (the kernels' plain versions) from the same weights and batch."""
    size = 256
    base, _, _ = build_trainer(torch, recipe, size, device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        model, state, step = build_trainer(torch, recipe, size, device=dev,
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
    valid = ", ".join(f"{k} {sg[k]:.0f} vs {sc[k]:.0f}" for k in sorted(sc)
                      if k.startswith("valid_n_"))
    log(f"training reference: {recipe} {size}^2, one step, card vs CPU: "
        f"loss {sg['loss']:.6f} vs {sc['loss']:.6f} (relative "
        f"{rel_loss:.2e}, tol {TRAIN_LOSS_RTOL:g}); {valid}; gradient "
        f"cosine {cos:.6f} (min "
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
    serve_totals, per_pair = {}, {}
    for recipe in RECIPES:
        totals, per_pair[recipe], matcher, request, _ = timed(
            f"serving {recipe}", serving_phase, torch, recipe)
        serve_totals[recipe] = totals
        timed(f"profile {recipe}", profile_phase, torch, recipe, matcher,
              request, recipe == RECIPES[0])
        del matcher
        torch.cuda.empty_cache()
    for recipe in RECIPES:
        timed(f"reference {recipe}", reference_phase, torch, recipe)
    train_totals, per_step = {}, {}
    for recipe in RECIPES:
        totals, per_step[recipe], step, state, batch, times = timed(
            f"training {recipe}", training_phase, torch, recipe)
        train_totals[recipe] = totals
        timed(f"training profile {recipe}", train_profile_phase, torch,
              recipe, step, state, batch, statistics.median(times))
        del step, state
        torch.cuda.empty_cache()
    for recipe in RECIPES:
        timed(f"training reference {recipe}", train_reference_phase, torch,
              recipe)

    # launches: the main paths' counts, summed over the recipes' runs, and
    # each recipe's count in its last request and its last step
    for row in rows:
        row["launches"] = sum(t[row["name"]] for t in serve_totals.values())
        row["launches_per_pair"] = {r: per_pair[r][row["name"]]
                                    for r in RECIPES}
    for row in train_rows:
        row["launches"] = sum(t[row["name"]] for t in train_totals.values())
        row["launches_per_step"] = {r: per_step[r][row["name"]]
                                    for r in RECIPES}
    log(json.dumps({"kernels": rows + train_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
