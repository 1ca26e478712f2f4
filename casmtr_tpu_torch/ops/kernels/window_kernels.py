"""Cascade window kernels: CUDA kernels B (window scores) and C (window
cross-attention) with their plain versions (counterpart of
casmtr_tpu/ops/pallas/window_kernels.py).

Both operate on the structured cascade candidate set: the four 2x2 child
queries of parent p see the (2w x 2w) patch of the target grid whose
top-left corner is ``corners[b, p] * 2`` (corners on the half grid), in the
candidate order c = (wy*w + wx)*4 + (dr*2 + dc).  Flat candidate indices
follow the JAX oracles' clipped gathers as flat indices, not per axis
(``kernels.clip_index``).

Each wrapper runs its plain version for CPU tensors, launches its kernel for
CUDA tensors, and raises for any other device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from casmtr_tpu_torch.ops import kernels


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


def window_patch_score(q_blk, feat1, corners, w: int) -> torch.Tensor:
    """Window scores [B, P, 4, 4w^2] (see the plain version).  CPU tensors
    take the plain version; CUDA tensors launch kernel B (f32 q_blk/feat1,
    int32 corners, all contiguous) or raise."""
    if q_blk.device.type == "cpu":
        return window_patch_score_plain(q_blk, feat1, corners, w)
    B, P, _, C = q_blk.shape
    H1, W1 = feat1.shape[1:3]
    dev = q_blk.device
    kernels.check_cuda(q_blk, "q_blk", (B, P, 4, C), torch.float32, dev)
    kernels.check_cuda(feat1, "feat1", (B, H1, W1, C), torch.float32, dev)
    kernels.check_cuda(corners, "corners", (B, P, 2), torch.int32, dev)
    if not 1 <= w <= 8:
        raise ValueError(f"window_patch_score: window {w} outside the "
                         "kernel's 1..8")
    out = torch.empty((B, P, 4, 4 * w * w), device=dev, dtype=torch.float32)
    kernels.launch(
        "casmtr_window_patch_score_f32", "window_patch_score", dev,
        q_blk.data_ptr(), feat1.data_ptr(), corners.data_ptr(),
        out.data_ptr(), B, P, C, H1, W1, w)
    return out


def window_cross_attention_plain(q, k, v, corners, hw_q: Tuple[int, int],
                                 hw_k: Tuple[int, int], w: int
                                 ) -> torch.Tensor:
    """Window cross-attention (port of window_cross_attention_oracle).

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D] on the (h1, w1) grid; corners:
    [B, Lq//4, 2] (y, x) on the half grid of the keys.  Each 2x2 query block
    attends, per head with one softmax over 4w^2 candidates, to its patch.
    Returns msg [B, Lq//4, 4, H, D] float32."""
    from casmtr_tpu_torch.ops.quadtree import block_children
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, Lq, H, D = q.shape
    idx = kernels.clip_index(_expand_corner_indices(corners, w, w1), h1 * w1)
    bi = torch.arange(B, device=q.device)[:, None, None]
    k_g = k[bi, idx]                                     # [B, P, C, H, D]
    v_g = v[bi, idx]
    qb = block_children(q, h0, w0)                       # [B, P, 4, H, D]
    qk = torch.einsum("bpfhd,bpchd->bpfhc", qb, k_g) * (D ** -0.5)
    a = torch.softmax(qk, dim=-1)
    return torch.einsum("bpfhc,bpchd->bpfhd", a, v_g)


def window_cross_attention(q, k, v, corners, hw_q: Tuple[int, int],
                           hw_k: Tuple[int, int], w: int) -> torch.Tensor:
    """Window cross-attention msg [B, P, 4, H, D] (see the plain version).
    CPU tensors take the plain version; CUDA tensors launch kernel C (f32
    q/k/v, int32 corners, all contiguous) or raise."""
    if q.device.type == "cpu":
        return window_cross_attention_plain(q, k, v, corners, hw_q, hw_k, w)
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, _, H, D = q.shape
    P = (h0 // 2) * (w0 // 2)
    if h0 % 2 or w0 % 2:
        raise ValueError(f"window_cross_attention: query grid {hw_q} must "
                         "have even sides")
    dev = q.device
    kernels.check_cuda(q, "q", (B, h0 * w0, H, D), torch.float32, dev)
    kernels.check_cuda(k, "k", (B, h1 * w1, H, D), torch.float32, dev)
    kernels.check_cuda(v, "v", (B, h1 * w1, H, D), torch.float32, dev)
    kernels.check_cuda(corners, "corners", (B, P, 2), torch.int32, dev)
    out = torch.empty((B, P, 4, H, D), device=dev, dtype=torch.float32)
    kernels.launch(
        "casmtr_window_cross_attention_f32", "window_cross_attention", dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), corners.data_ptr(),
        out.data_ptr(), B, P, H, D, h0, w0, h1, w1, w, float(D ** -0.5))
    return out
