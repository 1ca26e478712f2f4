"""Quadtree fine-level attention: CUDA kernel A and its plain version
(counterpart of casmtr_tpu/ops/pallas/quadtree_kernels.py).

``quadtree_fine_attention`` launches ``csrc/quadtree_fine.cu`` for CUDA
tensors and runs ``quadtree_fine_attention_plain`` for CPU tensors; any
other device raises.  The plain version is the port of the gather path of
``casmtr_tpu/ops/quadtree.py:_fine_level_b`` (its message part), and is the
kernel's oracle on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from casmtr_tpu_torch.ops import kernels


def quadtree_fine_attention_plain(q, k, v, topk_idx_prev,
                                  hw_q: Tuple[int, int],
                                  hw_k: Tuple[int, int]) -> torch.Tensor:
    """Gather-path fine-level message.

    q: [B, Lq, H, D]; k/v: [B, Lk, H, D]; topk_idx_prev: [B, P, K, H] flat
    block ids on the 2x coarser key grid (P = Lq // 4).  Each 2x2 child query
    block attends, per head, to the 4K children of its K selected blocks.
    Returns msg [B, P, 4, H, D] float32."""
    from casmtr_tpu_torch.ops.quadtree import block_children, to_block_major
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, _, H, D = q.shape
    K = topk_idx_prev.shape[2]
    qb = block_children(q, h0, w0)                           # [B, P, 4, H, D]
    P = qb.shape[1]
    kt = to_block_major(k, h1, w1)                           # [B, Lb, H, 4D]
    vt = to_block_major(v, h1, w1)
    ids = kernels.clip_index(topk_idx_prev.long(), kt.shape[1])
    bi = torch.arange(B, device=q.device)[:, None, None, None]
    hi = torch.arange(H, device=q.device)[None, None, None, :]
    k_g = kt[bi, ids, hi].reshape(B, P, K, H, 4, D)          # [B,P,K,H,4,D]
    v_g = vt[bi, ids, hi].reshape(B, P, K, H, 4, D)
    qk = torch.einsum("bpfhd,bpkhjd->bpfhkj", qb, k_g)
    qk = qk.reshape(B, P, 4, H, 4 * K) * (D ** -0.5)
    A = torch.softmax(qk, dim=-1).reshape(B, P, 4, H, K, 4)
    return torch.einsum("bpfhkj,bpkhjd->bpfhd", A, v_g)


def quadtree_fine_attention(q, k, v, topk_idx_prev, hw_q: Tuple[int, int],
                            hw_k: Tuple[int, int]) -> torch.Tensor:
    """Quadtree fine-level message [B, P, 4, H, D] (see the plain version).

    CPU tensors take the plain version; CUDA tensors launch kernel A (f32
    q/k/v, int32 ids, all contiguous) or raise."""
    if q.device.type == "cpu":
        return quadtree_fine_attention_plain(q, k, v, topk_idx_prev, hw_q,
                                             hw_k)
    h0, w0 = hw_q
    h1, w1 = hw_k
    B, Lq, H, D = q.shape
    P = (h0 // 2) * (w0 // 2)
    K = topk_idx_prev.shape[2]
    if h0 % 2 or w0 % 2 or h1 % 2 or w1 % 2:
        raise ValueError(f"quadtree_fine_attention: grids {hw_q}, {hw_k} "
                         "must have even sides")
    dev = q.device
    kernels.check_cuda(q, "q", (B, h0 * w0, H, D), torch.float32, dev)
    kernels.check_cuda(k, "k", (B, h1 * w1, H, D), torch.float32, dev)
    kernels.check_cuda(v, "v", (B, h1 * w1, H, D), torch.float32, dev)
    kernels.check_cuda(topk_idx_prev, "topk_idx_prev", (B, P, K, H),
                       torch.int32, dev)
    out = torch.empty((B, P, 4, H, D), device=dev, dtype=torch.float32)
    kernels.launch(
        "casmtr_quadtree_fine_attention_f32", "quadtree_fine_attention", dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), topk_idx_prev.data_ptr(),
        out.data_ptr(), B, P, K, H, D, h0, w0, h1, w1, float(D ** -0.5))
    return out
