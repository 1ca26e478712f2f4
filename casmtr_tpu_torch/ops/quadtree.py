"""Quadtree attention B and its cascade form (counterpart of
casmtr_tpu/ops/quadtree.py; only what ``qtatt_b`` and ``cascade_qtatt_b``
use on the 4c and 2c paths).

Semantics are the JAX package's: the pyramid runs coarsest to finest, full
attention plus top-k at the coarsest level, and at each finer level every
2x2 child query block attends to the children of the previous level's top-k
key blocks (candidate c = k*4 + (dr*2+dc)); the per-level messages merge with
softmax(level weight).  Token layout [B, L, H, D].

On the card the finest level's message goes through CUDA kernel A, and
every intermediate level's message and top-k selection through the fused
kernel A′ (ops/kernels/quadtree_kernels.py); both messages' gradients go
through kernel A-bwd.  The selection carries no gradient, as in the JAX
package (its callers use only the selected indices).  The cascade window
cross-attention goes through CUDA kernels C and C-bwd
(ops/kernels/window_kernels.py).

q/k/v may be bfloat16 (the gather tables of the bf16 eval path and of the
bf16 training step): every contraction then runs in float32 on the bf16
values, as the JAX package's ``preferred_element_type=float32`` does, so
no score, probability or message is rounded to bf16, and every message is
float32; in training the gradients flow back through the cast to bf16.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (
    quadtree_fine_attention, quadtree_fine_topk)
from casmtr_tpu_torch.ops.kernels.window_kernels import window_cross_attention


def block_children(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, h*w, ...] -> [B, (h//2)*(w//2), 4, ...] grouping 2x2 blocks, child
    order row-major within the block: (0,0), (0,1), (1,0), (1,1)."""
    B = x.shape[0]
    rest = x.shape[2:]
    x = x.reshape(B, h // 2, 2, w // 2, 2, *rest).transpose(2, 3)
    return x.reshape(B, (h // 2) * (w // 2), 4, *rest)


def unblock_children(x: torch.Tensor, h2: int, w2: int) -> torch.Tensor:
    """Inverse of ``block_children``: [B, h2*w2, 4, ...] -> [B, 4*h2*w2, ...]."""
    B = x.shape[0]
    rest = x.shape[3:]
    x = x.reshape(B, h2, w2, 2, 2, *rest).transpose(2, 3)
    return x.reshape(B, h2 * 2 * w2 * 2, *rest)


def to_block_major(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, L, H, D] tokens -> [B, L/4, H, 4*D] block-major table."""
    B, L, H, D = x.shape
    xb = block_children(x, h, w)                         # [B, L/4, 4, H, D]
    return xb.transpose(2, 3).reshape(B, L // 4, H, 4 * D)


def expand_child_indices(topk_idx: torch.Tensor, w_prev: int, w_cur: int,
                         dilated: int = 1, clamp_max=None) -> torch.Tensor:
    """[B, P, K, H] flat indices on the previous (2x coarser) grid ->
    [B, P, K*4, H] candidate indices on the current grid, c = k*4 + (dr*2+dc)."""
    rows = (topk_idx // w_prev) * 2
    cols = (topk_idx % w_prev) * 2
    cands = [(rows + dr) * w_cur + (cols + dc)
             for dr in (0, dilated) for dc in (0, dilated)]
    idx = torch.stack(cands, dim=3)                      # [B, P, K, 4, H]
    B, P, K = idx.shape[:3]
    idx = idx.reshape(B, P, K * 4, idx.shape[-1])
    if clamp_max is not None:
        idx = idx.clamp(0, clamp_max)
    return idx


def _coarse_level(q, k, v, topk: int):
    """Full attention + top-k at the coarsest level.  q/k/v: [B, L, H, D],
    widened to float32 (a bf16-rounded score would tie where the JAX
    package's float32 one does not).  Returns (message [B, L, H, D] float32,
    topk_idx [B, L, K, H] int32)."""
    D = q.shape[-1]
    q, k, v = q.float(), k.float(), v.float()
    qk = torch.einsum("blhd,bshd->blhs", q, k) * (D ** -0.5)
    A = torch.softmax(qk, dim=-1)
    _, ti = torch.topk(A, topk, dim=-1)                  # [B, L, H, K]
    message = torch.einsum("blhs,bshd->blhd", A, v)
    return message, ti.transpose(2, 3).to(torch.int32).contiguous()


def _fine_level_b(q, k, v, topk_idx_prev, topk: int, hw_q: Tuple[int, int],
                  hw_k: Tuple[int, int], need_topk: bool = True):
    """One fine level of QTAttB.  Returns (message [B, P, 4, H, D],
    topk_idx [B, Lq, topk, H] or None when ``need_topk`` is False -- the
    finest level, whose top-k nothing consumes)."""
    if not need_topk:
        return quadtree_fine_attention(q, k, v, topk_idx_prev, hw_q,
                                       hw_k), None
    msg, _, topk_idx = quadtree_fine_topk(q, k, v, topk_idx_prev, hw_q, hw_k,
                                          topk)
    return msg, topk_idx


def _merge_messages(messages: List[torch.Tensor],
                    parent_hw: List[Tuple[int, int]],
                    weight: torch.Tensor) -> torch.Tensor:
    """Merge per-level messages with softmax(weight), un-blocking 2x per
    level.  messages[0]: [B, L0, H, D] (coarsest); messages[i>0]:
    [B, P_i, 4, H, D]; parent_hw[i] is the previous level's (h, w)."""
    w = torch.softmax(weight, dim=0)
    final = messages[0] * w[0]
    for i in range(1, len(messages)):
        final = final[:, :, None] + messages[i] * w[i]
        final = unblock_children(final, *parent_hw[i])
    return final


def qtatt_b(queries: Sequence[torch.Tensor], keys: Sequence[torch.Tensor],
            values: Sequence[torch.Tensor], sizes: Sequence[Tuple[int, int]],
            topks: Sequence[int], merge_weight: torch.Tensor) -> torch.Tensor:
    """QTAttB forward.  queries/keys/values: pyramid lists, FINEST level
    first, each [B, L_i, H, D] contiguous; sizes: (h_i, w_i) finest first;
    topks: per level, coarsest first.  Returns the merged message
    [B, L_finest, H, D] float32."""
    n_levels = len(queries)
    messages, parent_hw = [], []
    topk_idx = None
    for i in range(n_levels):
        li = n_levels - 1 - i
        q, k, v = queries[li], keys[li], values[li]
        h, w = sizes[li]
        if i == 0:
            msg, topk_idx = _coarse_level(q, k, v, topks[0])
            parent_hw.append((h, w))
        else:
            msg, topk_idx = _fine_level_b(q, k, v, topk_idx, topks[i],
                                          (h, w), (h, w),
                                          need_topk=i < n_levels - 1)
            parent_hw.append(sizes[li + 1])
        messages.append(msg)
    return _merge_messages(messages, parent_hw, merge_weight)


def cascade_qtatt_b(q, k, v, topk_pos: torch.Tensor, hw_q: Tuple[int, int],
                    hw_k: Tuple[int, int], dilated: int = 1,
                    window_structured: bool = False):
    """CascadeQTAttB: window cross-attention over 2x-upsampled positions.

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D]; topk_pos: [B, P, Kw, 2] (row, col)
    window positions on the previous (2x coarser) grid of the keys, P ==
    Lq // 4.  Only the structured form runs here (a contiguous boundary-
    shifted window, dilation 1: its candidates are the (2w x 2w) patch at
    the window's top-left corner * 2), which kernel C computes.
    Returns (message [B, Lq, H, D], upsampled_idx [B, Lq, 4Kw])."""
    if not window_structured or dilated != 1:
        raise NotImplementedError(
            "cascade_qtatt_b: only the structured window propagation with "
            "dilation 1 is ported (ROADMAP queue A: the other "
            "propagations and relative PE)")
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, Lq, H, D = q.shape
    Kw = topk_pos.shape[2]
    w_prop = int(round(Kw ** 0.5))
    corners = topk_pos[:, :, 0, :].to(torch.int32).contiguous()
    msg = window_cross_attention(q, k, v, corners, hw_q, hw_k, w_prop)
    msg = unblock_children(msg, h0 // 2, w0 // 2)        # [B, Lq, H, D]

    flat_prev = topk_pos[..., 0] * (w1 // 2) + topk_pos[..., 1]  # [B, P, Kw]
    idx_sh = expand_child_indices(flat_prev[..., None], w1 // 2, w1,
                                  dilated=dilated,
                                  clamp_max=h1 * w1 - 1)[..., 0]  # [B, P, 4Kw]
    up_idx = idx_sh[:, :, None].expand(B, Lq // 4, 4, 4 * Kw)
    return msg, unblock_children(up_idx, h0 // 2, w0 // 2)
