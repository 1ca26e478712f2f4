"""Window and global self-attention blocks (counterpart of
casmtr_tpu/models/cascade_attention.py: GroupAttention, Attention, VITMlp,
GroupBlock, LocalBlock).  Twins uses GroupBlock; the 1/4 cascade self layers
use LocalBlock.  Tokens are [B, N, C].  Each block computes in the
``dtype`` its caller passes (default: the input's), steps cast by
models/precision.py; attention scores and softmaxes are float32 and the
probabilities are rounded to the values' dtype, as the JAX package's."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from casmtr_tpu_torch.models.precision import run


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C] (Swin-style)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """Inverse of window_partition: [B*nW, ws*ws, C] -> [B, H, W, C]."""
    C = wins.shape[-1]
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def pad_to_multiple(x: torch.Tensor, ws: int):
    """Zero-pad [B, H, W, C] bottom/right to multiples of ws."""
    _, H, W, _ = x.shape
    pad_b = (ws - H % ws) % ws
    pad_r = (ws - W % ws) % ws
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    return x, pad_b, pad_r


class GroupAttention(nn.Module):
    """Non-overlapping window MSA.  Padded positions attend only to padded
    keys and real ones only to real keys (a -1000 bias), masking each
    dimension only when it is padded, as the JAX package does."""

    def __init__(self, dim: int, num_heads: int, ws: int,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.ws = ws
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        B, N, C = x.shape
        dt = dtype or x.dtype
        nh, ws = self.num_heads, self.ws
        hd = C // nh
        xi, pad_b, pad_r = pad_to_multiple(x.reshape(B, h, w, C), ws)
        Hp, Wp = xi.shape[1:3]
        qkv = window_partition(run(self.qkv, xi, dt), ws)   # [BW, WW, 3C]
        BW, WW, _ = qkv.shape
        q, k, v = qkv.reshape(BW, WW, 3, nh, hd).unbind(2)
        attn = torch.einsum("wlhd,wshd->whls", q.float(),
                            k.float()) * (hd ** -0.5)
        if pad_b or pad_r:
            is_pad = torch.zeros((1, Hp, Wp, 1), device=x.device)
            if pad_b:
                is_pad[:, Hp - pad_b:] = 1.0
            if pad_r:
                is_pad[:, :, Wp - pad_r:] = 1.0
            pm = window_partition(is_pad, ws)[..., 0]        # [nW, WW]
            bias = ((pm[:, :, None] - pm[:, None, :]) != 0).float() * -1000.0
            nW = pm.shape[0]
            attn = (attn.reshape(B, nW, nh, WW, WW) + bias[:, None]) \
                .reshape(BW, nh, WW, WW)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("whls,wshd->wlhd", attn, v).reshape(BW, WW, C)
        out = window_reverse(out, ws, Hp, Wp)[:, :h, :w].reshape(B, N, C)
        return run(self.proj, out, dt)


class Attention(nn.Module):
    """Global MSA with spatial-reduction keys/values (a sr x sr stride-sr
    conv, floor padding, then LayerNorm) when sr_ratio > 1."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 qkv_bias: bool = False, ln_eps: float = 1e-5):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=ln_eps)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        B, N, C = x.shape
        dt = dtype or x.dtype
        nh = self.num_heads
        hd = C // nh
        q = run(self.q, x, dt).reshape(B, N, nh, hd)
        if self.sr_ratio > 1:
            xi = x.transpose(1, 2).reshape(B, C, h, w)
            xi = run(self.norm, run(self.sr, xi, dt).flatten(2).transpose(
                1, 2), dt)
        else:
            xi = x
        k, v = run(self.kv, xi, dt).reshape(B, -1, 2, nh, hd).unbind(2)
        attn = torch.softmax(torch.einsum("blhd,bshd->bhls", q.float(),
                                          k.float()) * (hd ** -0.5), dim=-1)
        out = torch.einsum("bhls,bshd->blhd", attn.to(v.dtype),
                           v).reshape(B, N, C)
        return run(self.proj, out, dt)


class VITMlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x, dtype=None):
        dt = dtype or x.dtype
        return run(self.fc2, F.gelu(run(self.fc1, x, dt)), dt)


class GroupBlock(nn.Module):
    """PreNorm (window when ws > 1, else global) MSA + MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, ws: int = 1, qkv_bias: bool = False,
                 ln_eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        if ws == 1:
            self.attn = Attention(dim, num_heads, sr_ratio, qkv_bias, ln_eps)
        else:
            self.attn = GroupAttention(dim, num_heads, ws, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = VITMlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        dt = dtype or x.dtype
        x = x.to(dt)
        x = x + self.attn(run(self.norm1, x, dt), h, w, dt)
        return x + self.mlp(run(self.norm2, x, dt), dt)


class LocalBlock(nn.Module):
    """Window block only."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ws: int = 1):
        super().__init__()
        self.block_local = GroupBlock(dim, num_heads, mlp_ratio, 1, ws)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        return self.block_local(x, h, w, dtype)
