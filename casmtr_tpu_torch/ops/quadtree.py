"""Quadtree attention A, B and Guided and the cascade form of B
(counterpart of casmtr_tpu/ops/quadtree.py and of the gathers of
casmtr_tpu/ops/gather_ops.py: ``qtatt_a``, ``qtatt_b``, ``qtatt_guided``
and ``cascade_qtatt_b``).

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
(ops/kernels/window_kernels.py); with a relative position bias, or on
another window than the structured one, it takes the JAX package's gather
path instead, in plain PyTorch.  Quadtree attention A has no Pallas kernel
in the JAX package and none here: it is plain PyTorch on every device
(``gather_scores``, ``gather_aggregate``).  Guided quadtree attention
(``qtatt_guided``) is QTAttB's fine level on a given guide, so kernel A;
levels with the 1/8 stack's relative position bias take the gather path
in plain PyTorch, as in the JAX package.

q/k/v may be bfloat16 (the gather tables of the bf16 eval path and of the
bf16 training step): every contraction then runs in float32 on the bf16
values, as the JAX package's ``preferred_element_type=float32`` does, so
no score, probability or message is rounded to bf16, and every message is
float32; in training the gradients flow back through the cast to bf16.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from casmtr_tpu_torch.ops import kernels
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


def _coarse_level(q, k, v, topk: int, rel=None):
    """Full attention + top-k at the coarsest level.  q/k/v: [B, L, H, D],
    widened to float32 (a bf16-rounded score would tie where the JAX
    package's float32 one does not); ``rel``: None or the level's relative
    position bias, ``rel(query_positions, key_positions)``: flat positions
    on the level's grid whose last axis is the head axis (of size 1 or H),
    broadcast together, to the bias of each head [..., H].
    Returns (message [B, L, H, D] float32, topk_idx [B, L, K, H] int32)."""
    D = q.shape[-1]
    q, k, v = q.float(), k.float(), v.float()
    qk = torch.einsum("blhd,bshd->blhs", q, k) * (D ** -0.5)
    if rel is not None:
        L, S = q.shape[1], k.shape[1]
        pos_q = torch.arange(L, device=q.device)[:, None, None]
        pos_k = torch.arange(S, device=q.device)[None, :, None]
        qk = qk + rel(pos_q, pos_k).transpose(1, 2)      # [L, H, S]
    A = torch.softmax(qk, dim=-1)
    _, ti = torch.topk(A, topk, dim=-1)                  # [B, L, H, K]
    message = torch.einsum("blhs,bshd->blhd", A, v)
    return message, ti.transpose(2, 3).to(torch.int32).contiguous()


def _fine_level_b(q, k, v, topk_idx_prev, topk: int, hw_q: Tuple[int, int],
                  hw_k: Tuple[int, int], need_topk: bool = True, rel=None):
    """One fine level of QTAttB.  Returns (message [B, P, 4, H, D],
    topk_idx [B, Lq, topk, H] or None when ``need_topk`` is False -- the
    finest level, whose top-k nothing consumes).  A level with a relative
    position bias ``rel`` (as ``_coarse_level``'s), gathered at each
    candidate, takes the gather path in plain PyTorch on every device, as
    the JAX package takes it; the others go through kernels A and A′."""
    if rel is not None:
        return _biased_fine_level(q, k, v, topk_idx_prev, topk, hw_q, hw_k,
                                  need_topk, rel)
    if not need_topk:
        return quadtree_fine_attention(q, k, v, topk_idx_prev, hw_q,
                                       hw_k), None
    msg, _, topk_idx = quadtree_fine_topk(q, k, v, topk_idx_prev, hw_q, hw_k,
                                          topk)
    return msg, topk_idx


def _biased_fine_level(q, k, v, topk_idx_prev, topk: int,
                       hw_q: Tuple[int, int], hw_k: Tuple[int, int],
                       need_topk: bool, rel):
    """``_fine_level_b`` with the relative position bias ``rel`` added to
    each child query's scores over its 4K candidates, on the JAX package's
    gather path: q/k/v widened to float32, candidates c = k*4 + (dr*2+dc),
    the top-k of the softmax with ties to the lower candidate.  Returns
    (message [B, P, 4, H, D] float32, topk_idx [B, Lq, topk, H] int32 or
    None)."""
    h0, w0 = hw_q
    q, k, v = q.float(), k.float(), v.float()
    idx = expand_child_indices(topk_idx_prev, hw_k[1] // 2, hw_k[1])
    pos_q = block_children(torch.arange(h0 * w0, device=q.device)[None], h0,
                           w0)[0]                        # [P, 4]
    qk = gather_scores(block_children(q, h0, w0), k, idx) * (
        q.shape[-1] ** -0.5)                             # [B, P, 4, 4K, H]
    A = torch.softmax(qk + rel(pos_q[None, :, :, None, None],
                               idx[:, :, None]), dim=3)
    msg = gather_aggregate(A, v, idx)
    if not need_topk:
        return msg, None
    _, local = topk_lowest_first(A.detach(), topk, 3)    # [B, P, 4, k, H]
    topk_idx = torch.gather(idx[:, :, None].expand(A.shape), 3, local)
    return msg, unblock_children(topk_idx, h0 // 2, w0 // 2).to(torch.int32)


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
            topks: Sequence[int], merge_weight: torch.Tensor,
            rel_pos=None) -> torch.Tensor:
    """QTAttB forward.  queries/keys/values: pyramid lists, FINEST level
    first, each [B, L_i, H, D] contiguous; sizes: (h_i, w_i) finest first;
    topks: per level, coarsest first; rel_pos: None, or per level,
    coarsest first, its relative position bias (``_coarse_level``).
    Returns the merged message [B, L_finest, H, D] float32."""
    n_levels = len(queries)
    messages, parent_hw = [], []
    topk_idx = None
    for i in range(n_levels):
        li = n_levels - 1 - i
        q, k, v = queries[li], keys[li], values[li]
        h, w = sizes[li]
        rel = rel_pos[i] if rel_pos is not None else None
        if i == 0:
            msg, topk_idx = _coarse_level(q, k, v, topks[0], rel)
            parent_hw.append((h, w))
        else:
            msg, topk_idx = _fine_level_b(q, k, v, topk_idx, topks[i],
                                          (h, w), (h, w),
                                          need_topk=i < n_levels - 1,
                                          rel=rel)
            parent_hw.append(sizes[li + 1])
        messages.append(msg)
    return _merge_messages(messages, parent_hw, merge_weight)


GUIDED_LEVELS = (
    "quadtree attention 'Guided' runs one pyramid level only: its guide "
    "has one row per cell of the 1/8 grid, and the JAX package's "
    "qtatt_guided reads those rows on the coarsest level's parent grid, "
    "which is that grid only with one level (topks of one entry, at the "
    "1/4 level)")


def qtatt_guided(queries: Sequence[torch.Tensor],
                 keys: Sequence[torch.Tensor],
                 values: Sequence[torch.Tensor],
                 sizes: Sequence[Tuple[int, int]], merge_weight: torch.Tensor,
                 guide: torch.Tensor) -> torch.Tensor:
    """QTAttGuided forward at its one level: each 2x2 child query block
    attends, per head, to the children of the blocks that ``guide``
    [B, P, K, H] (flat indices on the 2x coarser parent grid, P the
    parents of the level) names -- the fine level of QTAttB, so kernel A
    on the card and kernel A-bwd for its gradient -- and the message is
    weighted by softmax(merge_weight).  Pyramid lists as ``qtatt_b``'s, of
    one level; more raise ValueError (``GUIDED_LEVELS``).  Returns
    [B, L, H, D] float32."""
    if len(queries) != 1:
        raise ValueError(f"{GUIDED_LEVELS}; got {len(queries)} levels")
    q, k, v = queries[0], keys[0], values[0]
    h, w = sizes[0]
    P = (h // 2) * (w // 2)
    if guide.shape[1] != P:
        raise ValueError(f"{GUIDED_LEVELS}; the guide has "
                         f"{guide.shape[1]} rows for the {P} parents of a "
                         f"{h}x{w} level")
    msg, _ = _fine_level_b(q, k, v, guide, 0, (h, w), (h, w),
                           need_topk=False)
    weight = torch.softmax(merge_weight, dim=0)
    return unblock_children(msg * weight[0], h // 2, w // 2)


def topk_lowest_first(x: torch.Tensor, k: int, dim: int):
    """The ``k`` largest entries along ``dim``, in descending order, with
    ties to the lower index (the rule of the JAX package's CPU top-k,
    ``lax.top_k``).  Returns (values, indices)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def gather_keys(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-head row gather: table [B, Lk, H, D], idx [B, P, C, H] ->
    [B, P, C, H, D], out[b, p, c, h] = table[b, idx[b, p, c, h], h], under
    the clipped-gather rule."""
    B, Lk, H, _ = table.shape
    idx = kernels.clip_index(idx.long(), Lk)
    bi = torch.arange(B, device=table.device)[:, None, None, None]
    hi = torch.arange(H, device=table.device)[None, None, None, :]
    return table[bi, idx, hi]


def gather_scores(query: torch.Tensor, key: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """Scores [B, P, 4, C, H] of the 2x2-blocked queries [B, P, 4, H, D]
    against the candidate keys ``idx`` [B, P, C, H] (shared by the 4
    children) of key [B, Lk, H, D]."""
    return torch.einsum("bpfhd,bpchd->bpfch", query, gather_keys(key, idx))


def gather_aggregate(attn: torch.Tensor, value: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Message [B, P, 4, H, D] of the weights attn [B, P, 4, C, H] over the
    candidate values ``idx`` [B, P, C, H] of value [B, Lk, H, D]."""
    return torch.einsum("bpfch,bpchd->bpfhd", attn, gather_keys(value, idx))


def _drop(A: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``A`` with the entries at ``idx`` along ``dim`` set to 0."""
    return A * torch.ones_like(A).scatter(dim, idx, 0.0)


def qtatt_a(queries: Sequence[torch.Tensor], keys: Sequence[torch.Tensor],
            values: Sequence[torch.Tensor], sizes: Sequence[Tuple[int, int]],
            topks: Sequence[int]) -> torch.Tensor:
    """QTAttA forward, in plain PyTorch on every device (the JAX package
    has no kernel for it).  Pyramid lists as ``qtatt_b``'s, finest first.

    Against B: a level's message leaves out the keys it selects, which the
    next level refines instead (but the finest level keeps them); a fine
    level's scores are a softmax over each selected key's 4 children,
    times that key's score at the level above; and the messages are summed
    while un-blocking, with no merge weight.  q/k/v are widened to float32;
    returns [B, L_finest, H, D] float32."""
    n_levels = len(queries)
    messages, parent_hw = [], []
    topk_idx = topk_score = None
    for i in range(n_levels):
        li = n_levels - 1 - i
        q, k, v = (t[li].float() for t in (queries, keys, values))
        h, w = sizes[li]
        D = q.shape[-1]
        if i == 0:
            qk = torch.einsum("blhd,bshd->blsh", q, k) * (D ** -0.5)
            A = torch.softmax(qk, dim=2)
            topk_score, ti = topk_lowest_first(A, topks[0], 2)
            topk_idx = ti.to(torch.int32)                    # [B, L, K, H]
            msg = torch.einsum("blsh,bshd->blhd", _drop(A, ti, 2), v)
            parent_hw.append((h, w))
        else:
            K = topk_idx.shape[2]
            qb = block_children(q, h, w)                     # [B, P, 4, H, D]
            idx = expand_child_indices(topk_idx, sizes[li + 1][1], w)
            qk = gather_scores(qb, k, idx) * (D ** -0.5)     # [B, P, 4, 4K, H]
            B, P, _, _, H = qk.shape
            A = torch.softmax(qk.reshape(B, P, 4, K, 4, H), dim=4)
            A = (A * topk_score[:, :, None, :, None, :]).reshape(
                B, P, 4, 4 * K, H)
            if i < n_levels - 1:
                topk_score, local = topk_lowest_first(A, topks[i], 3)
                topk_idx = torch.gather(
                    idx[:, :, None].expand(A.shape), 3, local)
                msg = gather_aggregate(_drop(A, local, 3), v, idx)
                topk_score = unblock_children(topk_score, h // 2, w // 2)
                topk_idx = unblock_children(topk_idx, h // 2, w // 2)
            else:
                msg = gather_aggregate(A, v, idx)
            parent_hw.append(sizes[li + 1])
        messages.append(msg)
    final = messages[0]
    for i in range(1, n_levels):
        final = unblock_children(final[:, :, None] + messages[i],
                                 *parent_hw[i])
    return final


def _cascade_gather(q, k, v, idx_sh, hw_q: Tuple[int, int],
                    rel_pos=None) -> torch.Tensor:
    """The JAX package's gather path of ``cascade_qtatt_b``: the K||V rows
    of each parent's candidates ``idx_sh`` [B, P, 4Kw] gathered in one
    take, the windowed relative bias ``rel_pos`` [B, H, Lq, 4Kw] (if any)
    added to the scores before the softmax.  q/k/v widened to float32;
    returns the message [B, Lq, H, D] float32."""
    h0, w0 = hw_q
    B, Lq, H, D = q.shape
    q, k, v = q.float(), k.float(), v.float()
    qb = block_children(q, h0, w0)                       # [B, P, 4, H, D]
    kv = torch.cat([k.reshape(B, -1, H * D), v.reshape(B, -1, H * D)], -1)
    bi = torch.arange(B, device=q.device)[:, None, None]
    kv_g = kv[bi, kernels.clip_index(idx_sh.long(), kv.shape[1])]
    kv_g = kv_g.reshape(B, Lq // 4, idx_sh.shape[-1], 2, H, D)
    qk = torch.einsum("bpfhd,bpchd->bpfhc", qb, kv_g[:, :, :, 0]) * (
        D ** -0.5)
    if rel_pos is not None:
        rp = block_children(rel_pos.movedim(1, -1), h0, w0)  # [B,P,4,4Kw,H]
        qk = qk + rp.transpose(3, 4)
    A = torch.softmax(qk, dim=-1)
    msg = torch.einsum("bpfhc,bpchd->bpfhd", A, kv_g[:, :, :, 1])
    return unblock_children(msg, h0 // 2, w0 // 2)


def cascade_qtatt_b(q, k, v, topk_pos: torch.Tensor, hw_q: Tuple[int, int],
                    hw_k: Tuple[int, int], dilated: int = 1,
                    rel_pos=None, window_structured: bool = False):
    """CascadeQTAttB: window cross-attention over 2x-upsampled positions.

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D]; topk_pos: [B, P, Kw, 2] (row, col)
    window positions on the previous (2x coarser) grid of the keys, P ==
    Lq // 4; rel_pos: None, or the windowed relative position bias
    [B, H, Lq, 4Kw] of the indoor recipe.  The structured form without
    ``rel_pos`` (a contiguous boundary-shifted window, dilation 1: its
    candidates are the (2w x 2w) patch at the window's top-left corner
    * 2) goes through kernel C.  Any other (a relative bias, another
    propagation, a dilation: each candidate's children ``dilated`` apart)
    takes the JAX package's gather path, here in plain PyTorch on every
    device, as the JAX package has no kernel for it either.
    Returns (message [B, Lq, H, D], upsampled_idx [B, Lq, 4Kw])."""
    structured = window_structured and dilated == 1
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, Lq, H, D = q.shape
    Kw = topk_pos.shape[2]
    flat_prev = topk_pos[..., 0] * (w1 // 2) + topk_pos[..., 1]  # [B, P, Kw]
    idx_sh = expand_child_indices(flat_prev[..., None], w1 // 2, w1,
                                  dilated=dilated,
                                  clamp_max=h1 * w1 - 1)[..., 0]  # [B, P, 4Kw]
    if rel_pos is not None or not structured:
        msg = _cascade_gather(q, k, v, idx_sh, hw_q, rel_pos)
    else:
        corners = topk_pos[:, :, 0, :].to(torch.int32).contiguous()
        msg = window_cross_attention(q, k, v, corners, hw_q, hw_k,
                                     int(round(Kw ** 0.5)))
        msg = unblock_children(msg, h0 // 2, w0 // 2)    # [B, Lq, H, D]
    up_idx = idx_sh[:, :, None].expand(B, Lq // 4, 4, 4 * Kw)
    return msg, unblock_children(up_idx, h0 // 2, w0 // 2)
