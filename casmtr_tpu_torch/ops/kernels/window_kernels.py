"""Cascade window kernels: CUDA kernels B (window scores) and C (window
cross-attention), their backward kernels B-bwd and C-bwd, and the plain
versions of all four (counterpart of casmtr_tpu/ops/pallas/window_kernels.py).

Both operate on the structured cascade candidate set: the four 2x2 child
queries of parent p see the (2w x 2w) patch of the target grid whose
top-left corner is ``corners[b, p] * 2`` (corners on the half grid), in the
candidate order c = (wy*w + wx)*4 + (dr*2 + dc).  Flat candidate indices
follow the JAX oracles' clipped gathers as flat indices, not per axis
(``kernels.clip_index``); the scatter of B's backward follows the JAX
scatter rule instead (``scatter_index``).

Each wrapper runs its plain version for CPU tensors (ordinary autograd
differentiates it), goes through its autograd function for CUDA tensors
(the forward kernel, and the backward kernel for the gradient), and raises
for any other device.  Kernels C and C-bwd also take bfloat16 q/k/v (the
bf16 eval path and the bf16 training step): f32 arithmetic on the bf16
values, an f32 message, log-sum-exp and gradients; the autograd function
rounds dq, dk and dv to the inputs' dtype, as the JAX package's backward
does.  The plain versions widen bf16 inputs to f32.  B and B-bwd take
float32 only, as the JAX package feeds kernel B.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from casmtr_tpu_torch.ops import kernels


# Kernels B and B-bwd keep each parent's 4w^2 candidate positions in shared
# memory (kMaxWindow in csrc/window_score.cuh).
MAX_SCORE_WINDOW = 64


def _candidate_offsets(w: int) -> np.ndarray:
    """(dy, dx) pixel offsets from the patch corner, candidate-ordered."""
    return np.asarray([(2 * wy + dr, 2 * wx + dc)
                       for wy in range(w) for wx in range(w)
                       for dr in range(2) for dc in range(2)], np.int64)


def _expand_corner_indices(corners: torch.Tensor, w: int, W1: int
                           ) -> torch.Tensor:
    """Flat candidate indices [B, P, 4w^2] from patch corners [B, P, 2]."""
    off = torch.from_numpy(_candidate_offsets(w)).to(corners.device)
    rows = corners[..., 0:1].long() * 2 + off[:, 0]
    cols = corners[..., 1:2].long() * 2 + off[:, 1]
    return rows * W1 + cols


def scatter_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The index rule of the JAX package's scatter-add (``.at[].add``): a
    negative index counts once from the end, and an index still outside
    [0, n) is dropped (returned as -1)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, -1))


def window_patch_score_plain(q_blk, feat1, corners, w: int) -> torch.Tensor:
    """Scores [B, P, 4, 4w^2] of 2x2-blocked queries q_blk [B, P, 4, C]
    against the patch candidates of feat1 [B, H1, W1, C] (port of
    window_patch_score_jnp)."""
    B, P, _, C = q_blk.shape
    H1, W1 = feat1.shape[1:3]
    idx = kernels.clip_index(_expand_corner_indices(corners, w, W1), H1 * W1)
    f1 = feat1.reshape(B, H1 * W1, C)
    f1_g = f1[torch.arange(B, device=f1.device)[:, None, None], idx]
    return torch.einsum("bpfd,bpkd->bpfk", q_blk.float(), f1_g.float())


def window_patch_score_bwd_plain(q_blk, feat1, corners, g, w: int):
    """Gradients (dq [B, P, 4, C], dfeat1 [B, H1, W1, C]) of the window
    scores for their cotangent ``g`` [B, P, 4, 4w^2] (port of the custom
    VJP ``_bwd`` of window_patch_score_pallas): dq from the clipped gather
    of feat1, dfeat1 a scatter-add under ``scatter_index``."""
    B, P, _, C = q_blk.shape
    H1, W1 = feat1.shape[1:3]
    flat = _expand_corner_indices(corners, w, W1)            # [B, P, Kc]
    f1 = feat1.reshape(B, H1 * W1, C)
    bi = torch.arange(B, device=f1.device)[:, None, None]
    f1_g = f1[bi, kernels.clip_index(flat, H1 * W1)]          # [B, P, Kc, C]
    dq = torch.einsum("bpfk,bpkd->bpfd", g, f1_g)
    rows = torch.einsum("bpfk,bpfd->bpkd", g, q_blk)          # [B, P, Kc, C]
    sidx = scatter_index(flat, H1 * W1)
    keep = sidx >= 0
    dst = (bi * (H1 * W1) + sidx.clamp(min=0))[keep]
    df1 = f1.new_zeros((B * H1 * W1, C)).index_add_(0, dst, rows[keep])
    return dq, df1.reshape(feat1.shape)


def _check_score(q_blk, feat1, corners, w: int):
    """Kernel B's argument contract (CUDA tensors only)."""
    if not 1 <= w <= MAX_SCORE_WINDOW:
        raise ValueError(f"window_patch_score: window {w} outside the "
                         f"kernels' 1..{MAX_SCORE_WINDOW}")
    B, P, _, C = q_blk.shape
    H1, W1 = feat1.shape[1:3]
    dev = q_blk.device
    kernels.check_cuda(q_blk, "q_blk", (B, P, 4, C), torch.float32, dev)
    kernels.check_cuda(feat1, "feat1", (B, H1, W1, C), torch.float32, dev)
    kernels.check_cuda(corners, "corners", (B, P, 2), torch.int32, dev)
    return B, P, C, H1, W1


def _launch_score_fwd(q_blk, feat1, corners, w: int):
    B, P, C, H1, W1 = _check_score(q_blk, feat1, corners, w)
    dev = q_blk.device
    out = torch.empty((B, P, 4, 4 * w * w), device=dev, dtype=torch.float32)
    kernels.launch(
        "casmtr_window_patch_score_f32", "window_patch_score", dev,
        q_blk.data_ptr(), feat1.data_ptr(), corners.data_ptr(),
        out.data_ptr(), B, P, C, H1, W1, w)
    return out


def _launch_score_bwd(q_blk, feat1, corners, g, w: int):
    B, P, C, H1, W1 = _check_score(q_blk, feat1, corners, w)
    dev = q_blk.device
    kernels.check_cuda(g, "grad_out", (B, P, 4, 4 * w * w), torch.float32,
                       dev)
    dq = torch.empty_like(q_blk)
    df1 = torch.zeros_like(feat1)
    kernels.launch(
        "casmtr_window_patch_score_bwd_f32", "window_patch_score_bwd", dev,
        q_blk.data_ptr(), feat1.data_ptr(), corners.data_ptr(), g.data_ptr(),
        dq.data_ptr(), df1.data_ptr(), B, P, C, H1, W1, w)
    return dq, df1


def window_patch_score_bwd(q_blk, feat1, corners, g, w: int):
    """Gradients (dq, dfeat1) of the window scores for their cotangent ``g``
    (see the plain version).  CPU tensors take the plain version; CUDA
    tensors launch kernel B-bwd."""
    if q_blk.device.type == "cpu":
        return window_patch_score_bwd_plain(q_blk, feat1, corners, g, w)
    return _launch_score_bwd(q_blk, feat1, corners, g, w)


class WindowPatchScore(torch.autograd.Function):
    """Kernel B forward, kernel B-bwd backward; CPU tensors take the two
    plain versions instead (the tests use this to check the function's
    plumbing without a card)."""

    @staticmethod
    def forward(ctx, q_blk, feat1, corners, w):
        ctx.w = w
        ctx.save_for_backward(q_blk, feat1, corners)
        if q_blk.device.type == "cpu":
            return window_patch_score_plain(q_blk, feat1, corners, w)
        return _launch_score_fwd(q_blk, feat1, corners, w)

    @staticmethod
    def backward(ctx, g):
        q_blk, feat1, corners = ctx.saved_tensors
        dq, df1 = window_patch_score_bwd(q_blk, feat1, corners,
                                         g.contiguous(), ctx.w)
        return dq, df1, None, None


def window_patch_score(q_blk, feat1, corners, w: int) -> torch.Tensor:
    """Window scores [B, P, 4, 4w^2] (see the plain version).  CPU tensors
    take the plain version under ordinary autograd; CUDA tensors (f32
    q_blk/feat1, int32 corners, all contiguous) go through
    ``WindowPatchScore``: kernel B, and kernel B-bwd for the gradient.
    Anything else raises."""
    if q_blk.device.type == "cpu":
        return window_patch_score_plain(q_blk, feat1, corners, w)
    return WindowPatchScore.apply(q_blk, feat1, corners, w)


def window_cross_attention_plain(q, k, v, corners, hw_q: Tuple[int, int],
                                 hw_k: Tuple[int, int], w: int,
                                 with_lse: bool = False):
    """Window cross-attention (port of window_cross_attention_oracle).

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D] on the (h1, w1) grid (float32, or
    bfloat16 widened to float32 first); corners:
    [B, Lq//4, 2] (y, x) on the half grid of the keys.  Each 2x2 query block
    attends, per head with one softmax over 4w^2 candidates, to its patch.
    Returns msg [B, Lq//4, 4, H, D] float32, and with ``with_lse`` also the
    log-sum-exp of each softmax row [B, Lq//4, 4, H]."""
    from casmtr_tpu_torch.ops.quadtree import block_children
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, Lq, H, D = q.shape
    q, k, v = q.float(), k.float(), v.float()
    idx = kernels.clip_index(_expand_corner_indices(corners, w, w1), h1 * w1)
    bi = torch.arange(B, device=q.device)[:, None, None]
    k_g = k[bi, idx]                                     # [B, P, C, H, D]
    v_g = v[bi, idx]
    qb = block_children(q, h0, w0)                       # [B, P, 4, H, D]
    qk = torch.einsum("bpfhd,bpchd->bpfhc", qb, k_g) * (D ** -0.5)
    a = torch.softmax(qk, dim=-1)
    msg = torch.einsum("bpfhc,bpchd->bpfhd", a, v_g)
    if with_lse:
        return msg, torch.logsumexp(qk, dim=-1)
    return msg


def window_cross_attention_bwd_plain(q, k, v, corners, out, lse, g,
                                     hw_q: Tuple[int, int],
                                     hw_k: Tuple[int, int], w: int):
    """Gradients (dq [B, Lq, H, D], dk, dv [B, Lk, H, D]) of the window
    cross-attention for its cotangent ``g`` [B, P, 4, H, D], written out as
    kernel C-bwd computes them: probabilities recomputed from the forward's
    ``lse``, ``delta = rowsum(g * out)``, ``dS = P * (g.v - delta)``, dq from
    dS and the gathered keys, dk/dv summed over every occurrence of each key
    row with ``index_add_``.  bf16 q/k/v are widened first; the gradients
    are float32."""
    from casmtr_tpu_torch.ops.quadtree import block_children, unblock_children
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, Lk, H, D = k.shape
    scale = D ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    idx = kernels.clip_index(_expand_corner_indices(corners, w, w1), h1 * w1)
    bi = torch.arange(B, device=q.device)[:, None, None]
    k_g = k[bi, idx]                                     # [B, P, C, H, D]
    v_g = v[bi, idx]
    qb = block_children(q, h0, w0)                       # [B, P, 4, H, D]
    p = torch.exp(torch.einsum("bpfhd,bpchd->bpfhc", qb, k_g) * scale
                  - lse[..., None])                      # [B, P, 4, H, C]
    dp = torch.einsum("bpfhd,bpchd->bpfhc", g, v_g)
    ds = p * (dp - (g * out).sum(-1, keepdim=True))
    dq = torch.einsum("bpfhc,bpchd->bpfhd", ds, k_g) * scale
    dk_rows = torch.einsum("bpfhc,bpfhd->bpchd", ds, qb) * scale
    dv_rows = torch.einsum("bpfhc,bpfhd->bpchd", p, g)
    dst = (bi * Lk + idx).reshape(-1)
    dk = k.new_zeros((B * Lk, H, D)).index_add_(0, dst, dk_rows.flatten(0, 2))
    dv = v.new_zeros((B * Lk, H, D)).index_add_(0, dst, dv_rows.flatten(0, 2))
    return (unblock_children(dq, h0 // 2, w0 // 2), dk.reshape(k.shape),
            dv.reshape(v.shape))


def _check_wca(q, k, v, corners, hw_q, hw_k, w: int):
    """Kernel C's argument contract (CUDA tensors only; the shape, dtype
    and alignment limits come first, so they raise on any device).
    Returns (B, P, H, D, dtype); the q/k/v dtype picks the instance."""
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, _, H, D = q.shape
    P = (h0 // 2) * (w0 // 2)
    if h0 % 2 or w0 % 2:
        raise ValueError(f"window_cross_attention: query grid {hw_q} must "
                         "have even sides")
    if w < 1:
        raise ValueError(f"window_cross_attention: window {w} < 1")
    # whole rows are staged from one key position
    dtype = kernels.check_rows("window_cross_attention", q, k, v, H * D,
                               "row width H*D")
    dev = q.device
    kernels.check_cuda(q, "q", (B, h0 * w0, H, D), dtype, dev)
    kernels.check_cuda(k, "k", (B, h1 * w1, H, D), dtype, dev)
    kernels.check_cuda(v, "v", (B, h1 * w1, H, D), dtype, dev)
    kernels.check_cuda(corners, "corners", (B, P, 2), torch.int32, dev)
    return B, P, H, D, dtype


def _launch_wca_fwd(q, k, v, corners, hw_q, hw_k, w: int, with_lse: bool):
    B, P, H, D, dtype = _check_wca(q, k, v, corners, hw_q, hw_k, w)
    out = torch.empty((B, P, 4, H, D), device=q.device, dtype=torch.float32)
    lse = (torch.empty((B, P, 4, H), device=q.device, dtype=torch.float32)
           if with_lse else None)
    kernels.launch_instance(
        "window_cross_attention", dtype, q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), corners.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, P, H, D, *hw_q, *hw_k, w,
        float(D ** -0.5))
    return out, lse


def _launch_wca_bwd(q, k, v, corners, out, lse, g, hw_q, hw_k, w: int):
    """Kernel C-bwd, the instance of the q/k/v dtype; float32 gradients."""
    B, P, H, D, dtype = _check_wca(q, k, v, corners, hw_q, hw_k, w)
    kernels.check_cuda(out, "out", (B, P, 4, H, D), torch.float32, q.device)
    kernels.check_cuda(lse, "lse", (B, P, 4, H), torch.float32, q.device)
    kernels.check_cuda(g, "grad_out", (B, P, 4, H, D), torch.float32,
                       q.device)
    f32 = dict(dtype=torch.float32)
    dq = torch.empty_like(q, **f32)
    dk = torch.zeros_like(k, **f32)
    dv = torch.zeros_like(v, **f32)
    kernels.launch_instance(
        "window_cross_attention_bwd", dtype, q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), corners.data_ptr(), out.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, P, H, D, *hw_q, *hw_k, w, float(D ** -0.5))
    return dq, dk, dv


def window_cross_attention_bwd(q, k, v, corners, out, lse, g,
                               hw_q: Tuple[int, int], hw_k: Tuple[int, int],
                               w: int):
    """Gradients (dq, dk, dv; float32) of the window cross-attention for
    its cotangent ``g``, from the forward's output ``out`` and log-sum-exp
    ``lse`` (see the plain version).  CPU tensors take the plain version;
    CUDA tensors launch kernel C-bwd (its bf16 instance for bf16 q/k/v)."""
    if q.device.type == "cpu":
        return window_cross_attention_bwd_plain(q, k, v, corners, out, lse, g,
                                                hw_q, hw_k, w)
    return _launch_wca_bwd(q, k, v, corners, out, lse, g, hw_q, hw_k, w)


class WindowCrossAttention(torch.autograd.Function):
    """Kernel C forward, kernel C-bwd backward.  The forward writes the
    per-row log-sum-exp only when ``need_grad`` is set; the backward returns
    dq, dk and dv in the inputs' dtype.  CPU tensors take the two plain
    versions instead (the tests use this to check the function's plumbing
    without a card)."""

    @staticmethod
    def forward(ctx, q, k, v, corners, hw_q, hw_k, w, need_grad):
        if q.device.type == "cpu":
            out, lse = window_cross_attention_plain(q, k, v, corners, hw_q,
                                                    hw_k, w, True)
        else:
            out, lse = _launch_wca_fwd(q, k, v, corners, hw_q, hw_k, w,
                                       need_grad)
        ctx.args = (hw_q, hw_k, w)
        if need_grad:
            ctx.save_for_backward(q, k, v, corners, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, corners, out, lse = ctx.saved_tensors
        dq, dk, dv = window_cross_attention_bwd(q, k, v, corners, out, lse,
                                                g.contiguous(), *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def window_cross_attention(q, k, v, corners, hw_q: Tuple[int, int],
                           hw_k: Tuple[int, int], w: int) -> torch.Tensor:
    """Window cross-attention msg [B, P, 4, H, D] (see the plain version).
    CPU tensors take the plain version under ordinary autograd; CUDA tensors
    (f32 or bf16 q/k/v, int32 corners, all contiguous) go through
    ``WindowCrossAttention``: kernel C, and kernel C-bwd for the gradient
    (the instances of the q/k/v dtype).  Anything else raises."""
    if q.device.type == "cpu":
        return window_cross_attention_plain(q, k, v, corners, hw_q, hw_k, w)
    need_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return WindowCrossAttention.apply(q, k, v, corners, tuple(hw_q),
                                      tuple(hw_k), w, need_grad)
