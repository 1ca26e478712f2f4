"""Coarse-level transformer stacks (counterpart of
casmtr_tpu/models/transformer.py: Mlp, LoFTREncoderLayer, QuadtreeAttention,
QuadtreeBlock, LocalFeatureTransformer).  Tokens are [B, L, C]; module and
parameter names follow the reference torch modules, so ``state_dict`` keys
are the JAX package's flax paths as utils/convert.py maps them."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from casmtr_tpu_torch.ops.attention import full_attention, linear_attention
from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
from casmtr_tpu_torch.ops.quadtree import qtatt_b


class DWConv(nn.Module):
    """Depthwise 3x3 conv on a token grid."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        B, L, C = x.shape
        y = self.dwconv(x.transpose(1, 2).reshape(B, C, h, w))
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> ReLU -> 3x3 depthwise conv -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = self.dwconv(F.relu(self.fc1(x)), h, w)
        return self.fc2(F.gelu(x))


class LoFTREncoderLayer(nn.Module):
    """Linear/full-attention encoder layer with the concat-MLP residual."""

    def __init__(self, d_model: int, nhead: int, attention: str = "linear"):
        super().__init__()
        self.nhead = nhead
        self.attention = attention
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(nn.Linear(2 * d_model, 2 * d_model, bias=False),
                                 nn.ReLU(),
                                 nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, source, x_mask=None, source_mask=None):
        B, _, C = x.shape
        D = C // self.nhead
        q = self.q_proj(x).reshape(B, -1, self.nhead, D)
        k = self.k_proj(source).reshape(B, -1, self.nhead, D)
        v = self.v_proj(source).reshape(B, -1, self.nhead, D)
        attn = linear_attention if self.attention == "linear" else full_attention
        msg = attn(q, k, v, q_mask=x_mask, kv_mask=source_mask)
        msg = self.norm1(self.merge(msg.reshape(B, -1, C)))
        y = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + y


class QTAttB(nn.Module):
    """Holds the per-level merge logits of quadtree attention B
    (``py_att.weight``) and runs ``ops.quadtree.qtatt_b``."""

    def __init__(self, scale: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(scale))

    def forward(self, qs, ks, vs, sizes, topks):
        return qtatt_b(qs, ks, vs, sizes, topks, self.weight)


class QuadtreeAttention(nn.Module):
    """1x1-conv q/k/v projections, a 2x2 average-pool pyramid of ``scale``
    levels, quadtree attention B, and the output projection."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 scale: int = 3):
        super().__init__()
        self.num_heads = num_heads
        self.topks = tuple(topks)
        self.scale = scale
        self.q_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.k_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.v_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.py_att = QTAttB(scale)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, target, hw_x: Tuple[int, int],
                hw_t: Tuple[int, int]) -> torch.Tensor:
        B, L, C = x.shape
        h, w = hw_x
        D = C // self.num_heads
        q = self.q_proj(x.transpose(1, 2).reshape(B, C, h, w))
        k = self.k_proj(target.transpose(1, 2).reshape(B, C, *hw_t))
        v = self.v_proj(target.transpose(1, 2).reshape(B, C, *hw_t))

        def tokens(t):  # [B, C, hh, ww] -> [B, hh*ww, H, D] contiguous
            return t.flatten(2).transpose(1, 2).reshape(
                B, -1, self.num_heads, D).contiguous()

        qs, ks, vs, sizes = [], [], [], []
        for i in range(self.scale):
            qs.append(tokens(q))
            ks.append(tokens(k))
            vs.append(tokens(v))
            sizes.append(tuple(q.shape[-2:]))
            if i != self.scale - 1:
                q, k, v = avg_pool_2x2(q), avg_pool_2x2(k), avg_pool_2x2(v)
        msg = self.py_att(qs, ks, vs, sizes, self.topks)
        return self.proj(msg.reshape(B, L, C))


class QuadtreeBlock(nn.Module):
    """PreNorm quadtree attention + DWConv-MLP block; norm1 is shared by x
    and target."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 scale: int = 3, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = QuadtreeAttention(dim, num_heads, topks, scale)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, target, hw_x, hw_t):
        x = x + self.attn(self.norm1(x), self.norm1(target), hw_x, hw_t)
        return x + self.mlp(self.norm2(x), hw_x[0], hw_x[1])


class LocalFeatureTransformer(nn.Module):
    """Interleaved self/cross stack.  Quadtree cross layers update both
    images from the pre-update features (simultaneously); 'loftr' cross
    layers update them in sequence, so feat1 sees the new feat0."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        if config.block_type == "quadtree":
            if config.attn_type != "B" or config.relative_pe:
                raise NotImplementedError(
                    f"quadtree attention {config.attn_type!r} with "
                    f"relative_pe={config.relative_pe} is not ported yet "
                    "(ROADMAP queue A: QuadtreeLoFTR, the indoor recipe)")
            self.layers = nn.ModuleList(
                QuadtreeBlock(config.d_model, config.nhead, config.topks, 3)
                for _ in config.layer_names)
        elif config.block_type == "loftr":
            self.layers = nn.ModuleList(
                LoFTREncoderLayer(config.d_model, config.nhead,
                                  config.attention)
                for _ in config.layer_names)
        else:
            raise ValueError(config.block_type)

    def forward(self, feat0, feat1, hw0, hw1, mask0=None, mask1=None):
        loftr = self.config.block_type == "loftr"
        for layer, name in zip(self.layers, self.config.layer_names):
            if loftr:
                if name == "self":
                    feat0 = layer(feat0, feat0, mask0, mask0)
                    feat1 = layer(feat1, feat1, mask1, mask1)
                else:
                    feat0 = layer(feat0, feat1, mask0, mask1)
                    feat1 = layer(feat1, feat0, mask1, mask0)
            elif name == "self":
                feat0 = layer(feat0, feat0, hw0, hw0)
                feat1 = layer(feat1, feat1, hw1, hw1)
            else:
                feat0, feat1 = (layer(feat0, feat1, hw0, hw1),
                                layer(feat1, feat0, hw1, hw0))
        return feat0, feat1
