"""Window and global self-attention blocks and the large-kernel-attention
block (counterpart of casmtr_tpu/models/cascade_attention.py:
GroupAttention, Attention, VITMlp, GroupBlock, DoubleGroupBlock,
LocalBlock, LKA, VAN, LKABlock).  Twins uses GroupBlock; the cascade self
layers use LocalBlock ('local'), DoubleGroupBlock ('local_global') or
LKABlock ('LKA').  Tokens are [B, N, C].  Each attention block computes in
the ``dtype`` its caller passes (default: the input's), steps cast by
models/precision.py; attention scores and softmaxes are float32 and the
probabilities are rounded to the values' dtype, as the JAX package's.
LKABlock computes in float32 whatever its input, as the JAX package's
(its flax modules take no dtype)."""

from __future__ import annotations

import math

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


class DoubleGroupBlock(nn.Module):
    """A window block, then a global block with spatial-reduction keys and
    values (Twins-style)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, ws: int = 1):
        super().__init__()
        self.block_local = GroupBlock(dim, num_heads, mlp_ratio, 1, ws)
        self.block_global = GroupBlock(dim, num_heads, mlp_ratio, sr_ratio, 1)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        return self.block_global(self.block_local(x, h, w, dtype), h, w,
                                 dtype)


class LKA(nn.Module):
    """Large-kernel attention: a depthwise (2d-1)^2 conv, a depthwise
    dilated conv (kernel ceil(21/d), dilation d), a 1x1 conv, and the
    input gated by the result; paddings as the JAX package's explicit ones
    (every conv keeps the map's size)."""

    def __init__(self, dim: int, kernel_size: int = 21, dilation: int = 3):
        super().__init__()
        d = dilation
        self.conv0 = nn.Conv2d(dim, dim, 2 * d - 1, padding=d - 1,
                               groups=dim)
        ks = math.ceil(kernel_size / d)
        pad = math.ceil((kernel_size - d - 1) / 2)
        self.conv_spatial = nn.Conv2d(dim, dim, ks, padding=pad, dilation=d,
                                      groups=dim)
        self.conv1 = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class VAN(nn.Module):
    """1x1 conv, GELU, LKA, 1x1 conv, plus the input.  The JAX package
    names the two 1x1 convs ``proj_1`` and ``proj_2``, which its name
    rules map to ``proj.1`` and ``proj.2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.ModuleDict({"1": nn.Conv2d(dim, dim, 1),
                                   "2": nn.Conv2d(dim, dim, 1)})
        self.spatial_gating_unit = LKA(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.proj["1"](x))
        return self.proj["2"](self.spatial_gating_unit(y)) + x


class LKABlock(nn.Module):
    """BatchNorm, VAN and a conv MLP (1x1, 3x3 depthwise, GELU, 1x1), each
    residual scaled per channel by a layer scale (initially 1e-2).  In
    training the BatchNorms normalize with the batch statistics and move
    their running ones as flax's do (``resnet_fpn.BatchNorm2d``)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        # the backbone package imports this module (Twins' GroupBlock)
        from casmtr_tpu_torch.models.backbone.resnet_fpn import bn
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.norm1 = bn(dim)
        self.norm2 = bn(dim)
        self.attn = VAN(dim)
        self.mlp_fc1 = nn.Conv2d(dim, hidden, 1)
        self.mlp_dwconv_dwconv = nn.Conv2d(hidden, hidden, 3, padding=1,
                                           groups=hidden)
        self.mlp_fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """x: [B, h*w, C] in any dtype; returns float32 tokens."""
        B, N, C = x.shape
        xi = x.float().transpose(1, 2).reshape(B, C, h, w)
        xi = xi + self.layer_scale_1[:, None, None] * self.attn(
            self.norm1(xi))
        y = self.mlp_fc1(self.norm2(xi))
        y = self.mlp_fc2(F.gelu(self.mlp_dwconv_dwconv(y)))
        xi = xi + self.layer_scale_2[:, None, None] * y
        return xi.flatten(2).transpose(1, 2)
