"""Coarse-level transformer stacks and their precision policy (counterpart
of casmtr_tpu/models/transformer.py: transformer_dtype, Mlp,
LoFTREncoderLayer, QuadtreeAttention with attention A or B, QuadtreeBlock,
LocalFeatureTransformer).  Tokens are [B, L, C]; module and parameter names
follow the reference torch modules, so ``state_dict`` keys are the JAX
package's flax paths as utils/convert.py maps them.

A stack computes in ``transformer_dtype`` (each step cast by
models/precision.py), feeds the attention kernels q/k/v in
``table_dtype``, and returns float32 tokens for the matching heads.  A
block called on its own computes in the ``dtype`` passed (default: its
input's)."""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from casmtr_tpu_torch.models.precision import run
from casmtr_tpu_torch.ops.attention import full_attention, linear_attention
from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
from casmtr_tpu_torch.ops.quadtree import qtatt_a, qtatt_b


def transformer_dtype(device: torch.device, train: bool) -> torch.dtype:
    """The compute dtype of the coarse, cascade and fine stacks.
    ``CASMTR_TRANSFORMER_BF16=0/1`` forces float32 or bfloat16 in both
    modes; otherwise bfloat16 on the card in eval, float32 in training and
    on the CPU, as the JAX package chooses on its TPU.  Parameters and
    normalization statistics stay float32; attention scores and softmaxes
    are float32."""
    forced = os.environ.get("CASMTR_TRANSFORMER_BF16")
    if forced is not None:
        return torch.bfloat16 if forced == "1" else torch.float32
    cuda = torch.device(device).type == "cuda"
    return torch.bfloat16 if cuda and not train else torch.float32


def table_dtype(device: torch.device) -> torch.dtype:
    """The dtype of the q/k/v "gather tables" that the attention kernels
    A, A′ and C (and their backward kernels A-bwd and C-bwd) read, the JAX
    package's ``cdt``: float32 on the CPU, as the JAX package's CPU graph
    (bf16 stacks forced by the environment still feed the kernels float32
    there); on the card bfloat16, in eval and in training alike, which
    takes the kernels' bf16 instances.  One choice differs from the JAX
    package, which uses bf16 tables on its TPU whatever the stacks' dtype:
    ``CASMTR_TRANSFORMER_BF16=0`` (the stacks forced to float32) keeps the
    card's tables float32 too, so that with ``CASMTR_BACKBONE_BF16=0`` as
    well a request or a training step on the card is the all-float32
    graph."""
    cuda = torch.device(device).type == "cuda"
    if cuda and os.environ.get("CASMTR_TRANSFORMER_BF16") != "0":
        return torch.bfloat16
    return torch.float32


class DWConv(nn.Module):
    """Depthwise 3x3 conv on a token grid."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        B, L, C = x.shape
        y = run(self.dwconv, x.transpose(1, 2).reshape(B, C, h, w),
                dtype or x.dtype)
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> ReLU -> 3x3 depthwise conv -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        dt = dtype or x.dtype
        x = self.dwconv(F.relu(run(self.fc1, x, dt)), h, w, dt)
        return run(self.fc2, F.gelu(x), dt)


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

    def forward(self, x, source, x_mask=None, source_mask=None, dtype=None):
        B, _, C = x.shape
        dt = dtype or x.dtype
        x, source = x.to(dt), source.to(dt)
        D = C // self.nhead
        q = run(self.q_proj, x, dt).reshape(B, -1, self.nhead, D)
        k = run(self.k_proj, source, dt).reshape(B, -1, self.nhead, D)
        v = run(self.v_proj, source, dt).reshape(B, -1, self.nhead, D)
        attn = linear_attention if self.attention == "linear" else full_attention
        msg = attn(q, k, v, q_mask=x_mask, kv_mask=source_mask)  # float32
        msg = run(self.norm1, run(self.merge, msg.reshape(B, -1, C), dt), dt)
        y = run(self.norm2, run(self.mlp, torch.cat([x, msg], dim=-1), dt),
                dt)
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
    levels, quadtree attention ``attn_type`` ("B", with its merge logits
    ``py_att``, or "A", which has none), and the output projection."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 scale: int = 3, attn_type: str = "B"):
        super().__init__()
        if attn_type not in ("A", "B"):
            raise NotImplementedError(
                f"quadtree attention {attn_type!r} is not ported yet "
                "(ROADMAP queue A: Guided)")
        self.num_heads = num_heads
        self.topks = tuple(topks)
        self.scale = scale
        self.attn_type = attn_type
        self.q_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.k_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.v_proj = nn.Conv2d(dim, dim, 1, bias=False)
        if attn_type == "B":
            self.py_att = QTAttB(scale)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, target, hw_x: Tuple[int, int],
                hw_t: Tuple[int, int], dtype=None,
                tables=None) -> torch.Tensor:
        """Computes in ``dtype`` (default: x's) and pools the pyramid in it;
        the kernels read q/k/v cast to ``tables`` (default: float32)."""
        B, L, C = x.shape
        h, w = hw_x
        dt = dtype or x.dtype
        D = C // self.num_heads
        q = run(self.q_proj, x.transpose(1, 2).reshape(B, C, h, w), dt)
        k = run(self.k_proj, target.transpose(1, 2).reshape(B, C, *hw_t), dt)
        v = run(self.v_proj, target.transpose(1, 2).reshape(B, C, *hw_t), dt)

        def tokens(t):  # [B, C, hh, ww] -> [B, hh*ww, H, D] contiguous
            return t.flatten(2).transpose(1, 2).reshape(
                B, -1, self.num_heads, D).contiguous().to(
                    tables or torch.float32)

        qs, ks, vs, sizes = [], [], [], []
        for i in range(self.scale):
            qs.append(tokens(q))
            ks.append(tokens(k))
            vs.append(tokens(v))
            sizes.append(tuple(q.shape[-2:]))
            if i != self.scale - 1:
                q, k, v = avg_pool_2x2(q), avg_pool_2x2(k), avg_pool_2x2(v)
        if self.attn_type == "B":
            msg = self.py_att(qs, ks, vs, sizes, self.topks)  # float32
        else:
            msg = qtatt_a(qs, ks, vs, sizes, self.topks)
        return run(self.proj, msg.reshape(B, L, C), dt)


class QuadtreeBlock(nn.Module):
    """PreNorm quadtree attention + DWConv-MLP block; norm1 is shared by x
    and target."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 scale: int = 3, mlp_ratio: float = 4.0,
                 attn_type: str = "B"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = QuadtreeAttention(dim, num_heads, topks, scale,
                                      attn_type)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, target, hw_x, hw_t, dtype=None, tables=None):
        dt = dtype or x.dtype
        x, target = x.to(dt), target.to(dt)
        x = x + self.attn(run(self.norm1, x, dt), run(self.norm1, target, dt),
                          hw_x, hw_t, dt, tables)
        return x + self.mlp(run(self.norm2, x, dt), hw_x[0], hw_x[1], dt)


class LocalFeatureTransformer(nn.Module):
    """Interleaved self/cross stack.  Quadtree cross layers update both
    images from the pre-update features (simultaneously); 'loftr' cross
    layers update them in sequence, so feat1 sees the new feat0.  Computes
    in ``transformer_dtype`` and returns float32 tokens."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        if config.block_type == "quadtree":
            if config.relative_pe:
                raise NotImplementedError(
                    "the 1/8 quadtree stack's relative PE is not ported yet "
                    "(ROADMAP queue A: coarse relative PE)")
            self.layers = nn.ModuleList(
                QuadtreeBlock(config.d_model, config.nhead, config.topks, 3,
                              attn_type=config.attn_type)
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
        dt = transformer_dtype(feat0.device, self.training)
        tab = table_dtype(feat0.device)
        for layer, name in zip(self.layers, self.config.layer_names):
            if loftr:
                if name == "self":
                    feat0 = layer(feat0, feat0, mask0, mask0, dt)
                    feat1 = layer(feat1, feat1, mask1, mask1, dt)
                else:
                    feat0 = layer(feat0, feat1, mask0, mask1, dt)
                    feat1 = layer(feat1, feat0, mask1, mask0, dt)
            elif name == "self":
                feat0 = layer(feat0, feat0, hw0, hw0, dt, tab)
                feat1 = layer(feat1, feat1, hw1, hw1, dt, tab)
            else:
                feat0, feat1 = (layer(feat0, feat1, hw0, hw1, dt, tab),
                                layer(feat1, feat0, hw1, hw0, dt, tab))
        return feat0.float(), feat1.float()
