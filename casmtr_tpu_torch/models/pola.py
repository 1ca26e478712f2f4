"""POLA (patch-based overlapping attention) blocks (counterpart of
casmtr_tpu/models/pola.py: pola_relative_position_index,
neighborhood_patches, NeighborWindowAttention, POLAMlp, POLATransBlock).

Each ws x ws query window attends to the 3ws x 3ws neighbourhood centred on
it, with a learned relative position bias.  The neighbourhood is cut from
the map zero-padded by ws on each side, and the padded keys are not masked:
they enter the softmax with the key and value ``W x 0 + b``, as in the JAX
package.  The blocks compute in float32 whatever the stack's dtype, as the
JAX package's do (flax modules without a dtype, on float32 parameters).
MixAxialPOLABlock and MultiHeadAttention serve no recipe and are not
ported.  Tokens are [B, N, C]."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from casmtr_tpu_torch.models.cascade_attention import (pad_to_multiple,
                                                       window_partition,
                                                       window_reverse)


def pola_relative_position_index(ws: int, n_win: int = 3) -> np.ndarray:
    """Bias-table index [ws*ws, (n_win*ws)^2] of each (query, key) pair of a
    window and its neighbourhood (the reference's formula, bit for bit)."""
    qy, qx = np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ny, nx = np.meshgrid(np.arange(n_win * ws), np.arange(n_win * ws),
                         indexing="ij")
    q = np.stack([qy.ravel(), qx.ravel()])           # [2, ws*ws]
    n = np.stack([ny.ravel(), nx.ravel()])           # [2, (n_win*ws)^2]
    rel = q[:, :, None] - n[:, None, :]              # [2, Q, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += n_win * ws - 1
    rel[:, :, 1] += n_win * ws - 1
    rel[:, :, 0] *= (n_win + 1) * ws - 1
    return rel.sum(-1)


def neighborhood_patches(x: torch.Tensor, ws: int) -> torch.Tensor:
    """The 3ws x 3ws patch centred on each ws x ws window of x [B, Hp, Wp, C]
    (Hp, Wp multiples of ws), zero-padded by ws on each side: [B*nW,
    (3ws)^2, C], windows row-major, each patch row-major."""
    B, Hp, Wp, C = x.shape
    nh, nw = Hp // ws, Wp // ws
    xp = F.pad(x, (0, 0, ws, ws, ws, ws))
    blocks = xp.reshape(B, nh + 2, ws, nw + 2, ws, C)
    rows = torch.stack([blocks[:, i:i + nh] for i in range(3)], dim=2)
    # rows: [B, nh, 3, ws, nw+2, ws, C]
    full = torch.stack([rows[:, :, :, :, j:j + nw] for j in range(3)], dim=5)
    # full: [B, nh, 3, ws, nw, 3, ws, C] -> [B, nh, nw, 3, ws, 3, ws, C]
    full = full.permute(0, 1, 4, 2, 3, 5, 6, 7)
    return full.reshape(B * nh * nw, 9 * ws * ws, C)


class NeighborWindowAttention(nn.Module):
    """Multi-head attention of window queries over their neighbourhood's
    keys with the POLA relative position bias.  The bias table is a
    parameter; its index is a buffer that the state dict does not hold."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 neig_win_num: int = 1, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = ws = window_size
        n_win = 2 * neig_win_num + 1
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((n_win + 1) * ws - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            pola_relative_position_index(ws, n_win).reshape(-1)),
            persistent=False)
        self.Wq = nn.Linear(dim, dim, bias=qkv_bias)
        self.Wk = nn.Linear(dim, dim, bias=qkv_bias)
        self.Wv = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q, k, v):
        """q: [B', Nq, C] window queries; k/v: [B', Nk, C] (Nq = ws^2,
        Nk = (3ws)^2)."""
        Bq, Nq, C = q.shape
        H = self.num_heads
        hd = C // H
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(Nq, -1, H)
        qh = self.Wq(q).reshape(Bq, Nq, H, hd) * (hd ** -0.5)
        kh = self.Wk(k).reshape(Bq, -1, H, hd)
        vh = self.Wv(v).reshape(Bq, -1, H, hd)
        attn = torch.einsum("blhd,bshd->bhls", qh, kh)
        attn = torch.softmax(attn + bias.permute(2, 0, 1)[None], dim=-1)
        out = torch.einsum("bhls,bshd->blhd", attn, vh).reshape(Bq, Nq, C)
        return self.proj(out)


class POLAMlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class POLATransBlock(nn.Module):
    """PreNorm POLA attention + MLP block.  The map is zero-padded bottom
    and right to multiples of the window before the windows are cut, and
    cropped back after."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 neig_win_num: int = 1, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NeighborWindowAttention(dim, window_size, num_heads,
                                            neig_win_num)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = POLAMlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """x: [B, h*w, C] in any float dtype; returns float32."""
        x = x.float()
        B, L, C = x.shape
        ws = self.window_size
        xn, _, _ = pad_to_multiple(self.norm1(x).reshape(B, h, w, C), ws)
        Hp, Wp = xn.shape[1:3]
        kv = neighborhood_patches(xn, ws)
        y = self.attn(window_partition(xn, ws), kv, kv)
        x = x + window_reverse(y, ws, Hp, Wp)[:, :h, :w].reshape(B, L, C)
        return x + self.mlp(self.norm2(x))
