"""Dense attention primitives (counterpart of casmtr_tpu/ops/attention.py).

All functions take [B, L, H, D] token layouts and optional [B, L] masks and
compute in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def linear_attention(q, k, v, q_mask: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """O(N) linear attention with the elu+1 feature map."""
    q = F.elu(q.float()) + 1.0
    k = F.elu(k.float()) + 1.0
    v = v.float()
    if q_mask is not None:
        q = q * q_mask[:, :, None, None]
    if kv_mask is not None:
        k = k * kv_mask[:, :, None, None]
        v = v * kv_mask[:, :, None, None]
    v_len = v.shape[1]
    v = v / v_len
    kv = torch.einsum("bshd,bshv->bhdv", k, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", q, k.sum(dim=1)) + eps)
    return torch.einsum("blhd,bhdv,blh->blhv", q, kv, z) * v_len


def full_attention(q, k, v, q_mask: Optional[torch.Tensor] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard softmax attention; fully masked rows give a zero message."""
    q, k, v = q.float(), k.float(), v.float()
    qk = torch.einsum("blhd,bshd->blsh", q, k)
    masked = kv_mask is not None and q_mask is not None
    if masked:
        valid = (q_mask[:, :, None, None] * kv_mask[:, None, :, None]) > 0
        qk = qk.masked_fill(~valid, float("-inf"))
    A = torch.softmax(qk * (1.0 / q.shape[-1] ** 0.5), dim=2)
    if masked:
        A = torch.nan_to_num(A)
    return torch.einsum("blsh,bshd->blhd", A, v)
