"""Quadtree fine-level attention: CUDA kernels A, A′ and A-bwd and their
plain versions (counterpart of casmtr_tpu/ops/pallas/quadtree_kernels.py).

``quadtree_fine_attention`` runs ``quadtree_fine_attention_plain`` for CPU
tensors (ordinary autograd differentiates it) and, for CUDA tensors, the
autograd function ``QuadtreeFineAttention``, whose forward launches
``csrc/quadtree_fine.cu`` and whose backward
(``quadtree_fine_attention_bwd``) launches ``csrc/quadtree_fine_bwd.cu``;
any other device raises.  The forward plain version is the port of the
gather path of
``casmtr_tpu/ops/quadtree.py:_fine_level_b`` (its message part), and with
``quadtree_fine_attention_bwd_plain`` it is the kernels' oracle on the card.

``quadtree_fine_topk`` is the same level with the top-k selection of the
next level's blocks fused in (kernel A′, the ``n_topk > 0`` form of the
same CUDA body, through ``QuadtreeFineAttention`` with ``topk``; its
gradient is kernel A-bwd's, since the selection carries none).  Its plain
version ``quadtree_fine_topk_plain`` is the whole gather path of
``_fine_level_b`` with ``need_topk``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from casmtr_tpu_torch.ops import kernels


def _candidates(k, v, topk_idx_prev, hw_k: Tuple[int, int]):
    """Gathered candidate key/value rows [B, P, K, H, 4, D] and their flat
    positions [B, P, H, 4K] on the (h1, w1) key grid, candidate
    c = kk * 4 + (dr * 2 + dc), under the clipped-gather rule."""
    from casmtr_tpu_torch.ops.quadtree import to_block_major
    h1, w1 = hw_k
    B, _, H, D = k.shape
    P, K = topk_idx_prev.shape[1:3]
    kt = to_block_major(k, h1, w1)                           # [B, Lb, H, 4D]
    vt = to_block_major(v, h1, w1)
    ids = kernels.clip_index(topk_idx_prev.long(), kt.shape[1])
    bi = torch.arange(B, device=k.device)[:, None, None, None]
    hi = torch.arange(H, device=k.device)[None, None, None, :]
    k_g = kt[bi, ids, hi].reshape(B, P, K, H, 4, D)
    v_g = vt[bi, ids, hi].reshape(B, P, K, H, 4, D)
    j = torch.arange(4, device=k.device)
    rows = (ids // (w1 // 2))[..., None] * 2 + j // 2        # [B, P, K, H, 4]
    cols = (ids % (w1 // 2))[..., None] * 2 + j % 2
    pos = (rows * w1 + cols).permute(0, 1, 3, 2, 4).reshape(B, P, H, 4 * K)
    return k_g, v_g, pos


def _scores(qb, k_g, D: int):
    """Scaled scores [B, P, 4, H, 4K] of the child queries [B, P, 4, H, D]."""
    B, P, _, H, _ = qb.shape
    qk = torch.einsum("bpfhd,bpkhjd->bpfhkj", qb, k_g)
    return qk.reshape(B, P, 4, H, -1) * (D ** -0.5)


def _attend(q, k, v, topk_idx_prev, hw_q: Tuple[int, int],
            hw_k: Tuple[int, int]):
    """The gather path's scaled scores qk and softmax A [B, P, 4, H, 4K],
    message [B, P, 4, H, D] and candidate positions [B, P, H, 4K]."""
    from casmtr_tpu_torch.ops.quadtree import block_children
    B, _, H, D = q.shape
    K = topk_idx_prev.shape[2]
    qb = block_children(q, *hw_q)                            # [B, P, 4, H, D]
    k_g, v_g, pos = _candidates(k, v, topk_idx_prev, hw_k)
    qk = _scores(qb, k_g, D)
    A = torch.softmax(qk, dim=-1)
    msg = torch.einsum("bpfhkj,bpkhjd->bpfhd",
                       A.reshape(B, -1, 4, H, K, 4), v_g)
    return qk, A, msg, pos


def quadtree_fine_attention_plain(q, k, v, topk_idx_prev,
                                  hw_q: Tuple[int, int],
                                  hw_k: Tuple[int, int],
                                  with_lse: bool = False):
    """Gather-path fine-level message.

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D]; topk_idx_prev: [B, P, K, H] flat
    block ids on the 2x coarser key grid (P = Lq // 4).  Each 2x2 child query
    block attends, per head, to the 4K children of its K selected blocks.
    Returns msg [B, P, 4, H, D] float32, and with ``with_lse`` also the
    log-sum-exp of each softmax row [B, P, 4, H]."""
    qk, _, msg, _ = _attend(q, k, v, topk_idx_prev, hw_q, hw_k)
    if with_lse:
        return msg, torch.logsumexp(qk, dim=-1)
    return msg


def quadtree_fine_topk_plain(q, k, v, topk_idx_prev, hw_q: Tuple[int, int],
                             hw_k: Tuple[int, int], topk: int,
                             with_lse: bool = False):
    """Gather-path fine level with its top-k selection.

    As ``quadtree_fine_attention_plain``, and per child query row the
    ``topk`` largest probabilities of its softmax over the 4K candidates,
    in descending order, with their flat positions on the (h1, w1) key grid.
    Returns (msg [B, P, 4, H, D], topk_score [B, Lq, topk, H] float32,
    topk_idx [B, Lq, topk, H] int32), and with ``with_lse`` also the
    log-sum-exp [B, P, 4, H]."""
    from casmtr_tpu_torch.ops.quadtree import unblock_children
    h0, w0 = hw_q
    qk, A, msg, pos = _attend(q, k, v, topk_idx_prev, hw_q, hw_k)
    score, local = torch.topk(A, topk, dim=-1)               # [B, P, 4, H, k]
    idx = torch.gather(pos[:, :, None].expand(A.shape), 4, local)
    score = unblock_children(score.transpose(3, 4), h0 // 2, w0 // 2)
    idx = unblock_children(idx.transpose(3, 4), h0 // 2, w0 // 2)
    out = (msg, score, idx.to(torch.int32))
    if with_lse:
        return out + (torch.logsumexp(qk, dim=-1),)
    return out


def quadtree_fine_attention_bwd_plain(q, k, v, topk_idx_prev, out, lse, g,
                                      hw_q: Tuple[int, int],
                                      hw_k: Tuple[int, int]):
    """Gradients (dq [B, Lq, H, D], dk, dv [B, Lk, H, D]) of the fine-level
    message for its cotangent ``g`` [B, P, 4, H, D], written out as the
    kernel computes them: probabilities recomputed from the forward's
    ``lse``, ``delta = rowsum(g * out)``, ``dS = P * (g.v - delta)``, dq from
    dS and the gathered keys, dk/dv summed over every occurrence of each key
    row with ``index_add_``."""
    from casmtr_tpu_torch.ops.quadtree import block_children, unblock_children
    h0, w0 = hw_q
    B, Lk, H, D = k.shape
    K = topk_idx_prev.shape[2]
    scale = D ** -0.5
    qb = block_children(q, h0, w0)                           # [B, P, 4, H, D]
    P = qb.shape[1]
    k_g, v_g, pos = _candidates(k, v, topk_idx_prev, hw_k)
    k_g = k_g.reshape(B, P, K, H, 4, D).permute(0, 1, 3, 2, 4, 5)
    k_g = k_g.reshape(B, P, H, 4 * K, D)                     # [B, P, H, C, D]
    v_g = v_g.permute(0, 1, 3, 2, 4, 5).reshape(B, P, H, 4 * K, D)
    p = torch.exp(torch.einsum("bpfhd,bphcd->bpfhc", qb, k_g) * scale
                  - lse[..., None])                          # [B, P, 4, H, C]
    dp = torch.einsum("bpfhd,bphcd->bpfhc", g, v_g)
    delta = (g * out).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bpfhc,bphcd->bpfhd", ds, k_g) * scale
    dk_rows = torch.einsum("bpfhc,bpfhd->bphcd", ds, qb) * scale
    dv_rows = torch.einsum("bpfhc,bpfhd->bphcd", p, g)
    return (unblock_children(dq, h0 // 2, w0 // 2),
            _scatter_rows(dk_rows, pos, Lk), _scatter_rows(dv_rows, pos, Lk))


def _scatter_rows(rows, pos, Lk: int):
    """Sum candidate rows [B, P, H, C, D] into key rows [B, Lk, H, D] at
    their positions [B, P, H, C] (every occurrence adds)."""
    B, _, H, _, D = rows.shape
    bi = torch.arange(B, device=rows.device)[:, None, None, None]
    hi = torch.arange(H, device=rows.device)[None, None, :, None]
    flat = ((bi * Lk + pos) * H + hi).reshape(-1)            # rows of [B*Lk*H]
    out = rows.new_zeros((B * Lk * H, D))
    out.index_add_(0, flat, rows.reshape(-1, D))
    return out.reshape(B, Lk, H, D)


def _check(q, k, v, topk_idx_prev, hw_q, hw_k):
    """The kernels' argument contract (CUDA tensors only)."""
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, _, H, D = q.shape
    P = (h0 // 2) * (w0 // 2)
    if h0 % 2 or w0 % 2 or h1 % 2 or w1 % 2:
        raise ValueError(f"quadtree_fine_attention: grids {hw_q}, {hw_k} "
                         "must have even sides")
    # a thread owns at most 4 columns of 4 floats (1 when D % 4 != 0) of a
    # row of the 128-thread block (csrc/block_chunk.cuh)
    max_hd = 2048 if D % 4 == 0 else 512
    if H * D > max_hd:
        raise ValueError(f"quadtree_fine_attention: H*D = {H * D} floats, "
                         f"the kernels take at most {max_hd} for D = {D}")
    dev = q.device
    kernels.check_cuda(q, "q", (B, h0 * w0, H, D), torch.float32, dev)
    kernels.check_cuda(k, "k", (B, h1 * w1, H, D), torch.float32, dev)
    kernels.check_cuda(v, "v", (B, h1 * w1, H, D), torch.float32, dev)
    kernels.check_cuda(topk_idx_prev, "topk_idx_prev",
                       (B, P, topk_idx_prev.shape[2], H), torch.int32, dev)


def _launch_fwd(q, k, v, ids, hw_q, hw_k, with_lse: bool, topk: int = 0):
    """Kernel A (``topk`` 0) or A′ (``topk`` > 0).  Returns (out, lse,
    score, idx); lse is None without ``with_lse``, score and idx are None
    for kernel A."""
    _check(q, k, v, ids, hw_q, hw_k)
    B, Lq, H, D = q.shape
    P, K = ids.shape[1:3]
    if not 0 <= topk <= 4 * K:
        raise ValueError(f"quadtree_fine_topk: topk {topk} outside "
                         f"[0, {4 * K}] (4K candidates; 0 is kernel A)")
    dev = q.device
    out = torch.empty((B, P, 4, H, D), device=dev, dtype=torch.float32)
    lse = (torch.empty((B, P, 4, H), device=dev, dtype=torch.float32)
           if with_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ids.data_ptr(),
            out.data_ptr(), lse_ptr)
    if not topk:
        kernels.launch("casmtr_quadtree_fine_attention_f32",
                       "quadtree_fine_attention", dev, *args, B, P, K, H, D,
                       *hw_q, *hw_k, float(D ** -0.5))
        return out, lse, None, None
    score = torch.empty((B, Lq, topk, H), device=dev, dtype=torch.float32)
    idx = torch.empty((B, Lq, topk, H), device=dev, dtype=torch.int32)
    kernels.launch("casmtr_quadtree_fine_topk_f32", "quadtree_fine_topk", dev,
                   *args, score.data_ptr(), idx.data_ptr(), B, P, K, H, D,
                   *hw_q, *hw_k, topk, float(D ** -0.5))
    return out, lse, score, idx


def _launch_bwd(q, k, v, ids, out, lse, g, hw_q, hw_k):
    _check(q, k, v, ids, hw_q, hw_k)
    B, _, H, D = q.shape
    P, K = ids.shape[1:3]
    kernels.check_cuda(out, "out", (B, P, 4, H, D), torch.float32, q.device)
    kernels.check_cuda(lse, "lse", (B, P, 4, H), torch.float32, q.device)
    kernels.check_cuda(g, "grad_out", (B, P, 4, H, D), torch.float32,
                       q.device)
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    kernels.launch(
        "casmtr_quadtree_fine_attention_bwd_f32",
        "quadtree_fine_attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), ids.data_ptr(), out.data_ptr(), lse.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, P, K, H,
        D, *hw_q, *hw_k, float(D ** -0.5))
    return dq, dk, dv


def quadtree_fine_attention_bwd(q, k, v, topk_idx_prev, out, lse, g,
                                hw_q: Tuple[int, int], hw_k: Tuple[int, int]):
    """Gradients (dq, dk, dv) of the fine-level message for its cotangent
    ``g``, from the forward's output ``out`` and log-sum-exp ``lse`` (see
    the plain version).  CPU tensors take the plain version; CUDA tensors
    launch kernel A-bwd."""
    if q.device.type == "cpu":
        return quadtree_fine_attention_bwd_plain(q, k, v, topk_idx_prev, out,
                                                 lse, g, hw_q, hw_k)
    return _launch_bwd(q, k, v, topk_idx_prev, out, lse, g, hw_q, hw_k)


class QuadtreeFineAttention(torch.autograd.Function):
    """Kernel A forward (``topk`` 0), or kernel A′ forward (``topk`` > 0:
    also the top-k selection, whose score and index outputs are not
    differentiable); kernel A-bwd backward of the message in both cases.
    The forward writes the per-row log-sum-exp only when ``need_grad`` is
    set.  CPU tensors take the plain versions instead (the tests use this to
    check the function's plumbing without a card)."""

    @staticmethod
    def forward(ctx, q, k, v, topk_idx_prev, hw_q, hw_k, need_grad, topk=0):
        if q.device.type == "cpu":
            if topk:
                out, score, idx, lse = quadtree_fine_topk_plain(
                    q, k, v, topk_idx_prev, hw_q, hw_k, topk, with_lse=True)
            else:
                out, lse = quadtree_fine_attention_plain(
                    q, k, v, topk_idx_prev, hw_q, hw_k, True)
        else:
            out, lse, score, idx = _launch_fwd(q, k, v, topk_idx_prev, hw_q,
                                               hw_k, need_grad, topk)
        ctx.hw = (hw_q, hw_k)
        if need_grad:
            ctx.save_for_backward(q, k, v, topk_idx_prev, out, lse)
        if not topk:
            return out
        ctx.mark_non_differentiable(score, idx)
        return out, score, idx

    @staticmethod
    def backward(ctx, g, *_):
        q, k, v, ids, out, lse = ctx.saved_tensors
        dq, dk, dv = quadtree_fine_attention_bwd(q, k, v, ids, out, lse,
                                                 g.contiguous(), *ctx.hw)
        return dq, dk, dv, None, None, None, None, None


def quadtree_fine_attention(q, k, v, topk_idx_prev, hw_q: Tuple[int, int],
                            hw_k: Tuple[int, int]) -> torch.Tensor:
    """Quadtree fine-level message [B, P, 4, H, D] (see the plain version).

    CPU tensors take the plain version under ordinary autograd; CUDA
    tensors (f32 q/k/v, int32 ids, all contiguous) go through
    ``QuadtreeFineAttention``: kernel A, and kernel A-bwd for the gradient.
    Anything else raises."""
    if q.device.type == "cpu":
        return quadtree_fine_attention_plain(q, k, v, topk_idx_prev, hw_q,
                                             hw_k)
    return QuadtreeFineAttention.apply(q, k, v, topk_idx_prev, tuple(hw_q),
                                       tuple(hw_k), _need_grad(q, k, v), 0)


def _need_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def quadtree_fine_topk(q, k, v, topk_idx_prev, hw_q: Tuple[int, int],
                       hw_k: Tuple[int, int], topk: int):
    """Fine-level message [B, P, 4, H, D] with the top-k selection of its
    child rows, topk_score and topk_idx [B, Lq, topk, H] (see the plain
    version); the selection carries no gradient.

    CPU tensors take the plain version (the message under autograd, the
    score detached); CUDA tensors go through ``QuadtreeFineAttention`` with
    ``topk``: kernel A′, and kernel A-bwd for the message's gradient.
    Anything else raises."""
    if q.device.type == "cpu":
        msg, score, idx = quadtree_fine_topk_plain(q, k, v, topk_idx_prev,
                                                   hw_q, hw_k, topk)
        return msg, score.detach(), idx
    return QuadtreeFineAttention.apply(q, k, v, topk_idx_prev, tuple(hw_q),
                                       tuple(hw_k), _need_grad(q, k, v),
                                       int(topk))
