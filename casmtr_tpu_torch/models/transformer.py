"""Coarse-level transformer stacks and their precision policy (counterpart
of casmtr_tpu/models/transformer.py: transformer_dtype, Mlp,
LoFTREncoderLayer, QuadtreeAttention with attention A, B or Guided,
QuadtreeBlock, relative_position_bucket, LocalFeatureTransformer with its
relative PE).  Tokens are [B, L, C]; module and parameter names
follow the reference torch modules, so ``state_dict`` keys are the JAX
package's flax paths as utils/convert.py maps them.

A stack computes in ``transformer_dtype`` (each step cast by
models/precision.py), feeds the attention kernels q/k/v in
``table_dtype``, and returns float32 tokens for the matching heads.  A
block called on its own computes in the ``dtype`` passed (default: its
input's).

With ``remat`` (``loftr.remat``, default True as in the JAX package) a
stack in training with gradients on runs each attention layer under
``layer_call``: its activations are dropped after the forward and
recomputed in the backward pass, as the JAX package's ``nn.remat``; the
eval forward is unchanged."""

from __future__ import annotations

import math
import os
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from casmtr_tpu_torch.models.precision import run
from casmtr_tpu_torch.ops import kernels
from casmtr_tpu_torch.ops.attention import full_attention, linear_attention
from casmtr_tpu_torch.ops.image_ops import avg_pool_2x2
from casmtr_tpu_torch.ops.quadtree import qtatt_a, qtatt_b, qtatt_guided


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


def layer_call(layer: nn.Module, remat: bool, *args, **kwargs):
    """``layer(*args, **kwargs)``; with ``remat`` under
    ``torch.utils.checkpoint`` without reentry, which keeps only the
    layer's inputs and recomputes its forward (the kernels' forward
    launches included) in the backward pass."""
    if remat:
        return checkpoint(layer, *args, use_reentrant=False, **kwargs)
    return layer(*args, **kwargs)


def remats(module: nn.Module) -> bool:
    """Whether a stack rematerializes its layers now: its ``remat`` flag in
    training with gradients on."""
    return module.remat and module.training and torch.is_grad_enabled()


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
    """Holds the per-level merge logits of quadtree attention B and Guided
    (``py_att.weight``) and runs ``ops.quadtree.qtatt_b``."""

    def __init__(self, scale: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(scale))

    def forward(self, qs, ks, vs, sizes, topks, rel_pos=None):
        return qtatt_b(qs, ks, vs, sizes, topks, self.weight, rel_pos)


class QuadtreeAttention(nn.Module):
    """1x1-conv q/k/v projections, a 2x2 average-pool pyramid of ``scale``
    levels, quadtree attention ``attn_type`` ("B" or "Guided", with the
    merge logits ``py_att``, or "A", which has none), and the output
    projection."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 scale: int = 3, attn_type: str = "B"):
        super().__init__()
        if attn_type not in ("A", "B", "Guided"):
            raise ValueError(f"quadtree attention {attn_type!r}")
        self.num_heads = num_heads
        self.topks = tuple(topks)
        self.scale = scale
        self.attn_type = attn_type
        self.q_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.k_proj = nn.Conv2d(dim, dim, 1, bias=False)
        self.v_proj = nn.Conv2d(dim, dim, 1, bias=False)
        if attn_type != "A":
            self.py_att = QTAttB(scale)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, target, hw_x: Tuple[int, int],
                hw_t: Tuple[int, int], dtype=None, tables=None,
                topk_pos=None, rel_pos=None) -> torch.Tensor:
        """Computes in ``dtype`` (default: x's) and pools the pyramid in it;
        the kernels read q/k/v cast to ``tables`` (default: float32).
        Guided attention reads its guide ``topk_pos`` [B, P, K, H]; B adds
        the per-level relative position biases ``rel_pos`` (coarsest
        first, ``ops.quadtree.qtatt_b``), which A and Guided ignore, as in
        the JAX package."""
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
            msg = self.py_att(qs, ks, vs, sizes, self.topks,
                              rel_pos)                 # float32
        elif self.attn_type == "Guided":
            msg = qtatt_guided(qs, ks, vs, sizes, self.py_att.weight,
                               topk_pos)
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

    def forward(self, x, target, hw_x, hw_t, dtype=None, tables=None,
                topk_pos=None, rel_pos=None):
        dt = dtype or x.dtype
        x, target = x.to(dt), target.to(dt)
        x = x + self.attn(run(self.norm1, x, dt), run(self.norm1, target, dt),
                          hw_x, hw_t, dt, tables, topk_pos, rel_pos)
        return x + self.mlp(run(self.norm2, x, dt), hw_x[0], hw_x[1], dt)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5-style bidirectional log buckets of integer offsets ``rel``: the
    sign picks a half of the ``num_buckets``; offsets below a quarter of
    them keep their own bucket, larger ones share log-spaced buckets up to
    ``max_distance``.  Computed in float32 as the JAX package does."""
    nb = num_buckets // 2
    ret = (rel > 0).to(torch.int64) * nb
    n = rel.abs()
    max_exact = max(nb // 2, 1)
    max_distance = max(max_distance, max_exact + 1)
    large = max_exact + (
        torch.log(n.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).to(torch.int64)
    large = large.clamp(max=nb - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int64), large)


class _TableLookup(torch.autograd.Function):
    """``table[bucket[..., h], h]`` for a bias table [nb, H] and buckets
    [..., H] (or [..., 1], shared by the heads).  Millions of lookups land
    on the table's few hundred entries, where the backward of advanced
    indexing (a sort of every index) is slow; this one sums the gradient
    per entry as a weighted histogram instead (``torch.bincount``)."""

    @staticmethod
    def forward(ctx, table, bucket):
        ctx.save_for_backward(bucket)
        ctx.nb = table.shape[0]
        return table[bucket, torch.arange(table.shape[1],
                                          device=table.device)]

    @staticmethod
    def backward(ctx, g):
        bucket, = ctx.saved_tensors
        H = g.shape[-1]
        flat = bucket.expand(g.shape) * H + torch.arange(H, device=g.device)
        grad = torch.bincount(flat.reshape(-1), weights=g.reshape(-1),
                              minlength=ctx.nb * H)
        return grad.reshape(ctx.nb, H).to(g.dtype), None


class RelativePositionBias:
    """The 1/8 stack's 2-D relative position bias at one pyramid level
    (grid ``hw``): for a query and a key position (flat on the grid, by
    rows), the x and y offsets of the key from the query, each bucketed
    over the tables' ``num_buckets`` (``max_distance`` the grid's width or
    height), through ``w_table`` (x) and ``h_table`` (y), nn.Linear
    weights [H, num_buckets].  The JAX package builds the dense
    [1, H, hw, hw] bias from one-hot buckets through the tables and
    gathers it at the candidates; a row lookup is the same number
    without the dense bias.  Key positions follow the clipped-gather
    rule, as the JAX package's gather of that bias."""

    def __init__(self, w_table: torch.Tensor, h_table: torch.Tensor,
                 hw: Tuple[int, int]):
        self.w_table, self.h_table = w_table, h_table
        self.hw = hw

    def __call__(self, pos_q: torch.Tensor, pos_k: torch.Tensor):
        """Positions whose last axis is the head axis (size 1 or H),
        broadcast together; returns the bias [..., H] float32."""
        hh, ww = self.hw
        nb = self.w_table.shape[1]
        pos_k = kernels.clip_index(pos_k, hh * ww)
        dx = relative_position_bucket(pos_k % ww - pos_q % ww, nb, ww)
        dy = relative_position_bucket(pos_k // ww - pos_q // ww, nb, hh)
        return (_TableLookup.apply(self.w_table.float().t(), dx)
                + _TableLookup.apply(self.h_table.float().t(), dy))


class LocalFeatureTransformer(nn.Module):
    """Interleaved self/cross stack.  Quadtree cross layers update both
    images from the pre-update features (simultaneously); 'loftr' cross
    layers update them in sequence, so feat1 sees the new feat0.  Computes
    in ``transformer_dtype`` and returns float32 tokens.  A quadtree stack
    with ``relative_pe`` holds per pyramid level i the bias tables
    ``w_pos_bias.i`` and ``h_pos_bias.i`` of ``train_size // 2^i`` buckets
    (``train_size``: the stack's grid side at the training size), which
    every layer's attention B adds at every level (plain PyTorch: such
    levels do not go through kernels A and A′).  ``remat``: each layer
    under ``layer_call`` in training (``remats``)."""

    def __init__(self, config, train_size: int = 0, remat: bool = True):
        super().__init__()
        self.config = config
        self.remat = remat
        if config.block_type == "quadtree":
            if config.attn_type == "Guided":
                raise ValueError(
                    "quadtree attention 'Guided' cannot run in the 1/8 "
                    "stack: it needs a guide, and the JAX package's 1/8 "
                    "stack passes none (topk_pos=None)")
            self.layers = nn.ModuleList(
                QuadtreeBlock(config.d_model, config.nhead, config.topks, 3,
                              attn_type=config.attn_type)
                for _ in config.layer_names)
            if config.relative_pe:
                if train_size < 4:
                    raise ValueError("the 1/8 stack's relative PE needs "
                                     "its grid side at the training size")
                nb = [train_size // 2 ** i for i in range(3)]
                self.w_pos_bias = nn.ModuleList(
                    nn.Linear(n, config.nhead, bias=False) for n in nb)
                self.h_pos_bias = nn.ModuleList(
                    nn.Linear(n, config.nhead, bias=False) for n in nb)
        elif config.block_type == "loftr":
            self.layers = nn.ModuleList(
                LoFTREncoderLayer(config.d_model, config.nhead,
                                  config.attention)
                for _ in config.layer_names)
        else:
            raise ValueError(config.block_type)

    def relative_biases(self, hw: Tuple[int, int]):
        """The per-level relative position biases of the quadtree pyramid
        on the grid ``hw``, coarsest level first."""
        h, w = hw
        return [RelativePositionBias(self.w_pos_bias[i].weight,
                                     self.h_pos_bias[i].weight,
                                     (h // 2 ** i, w // 2 ** i))
                for i in (2, 1, 0)]

    def forward(self, feat0, feat1, hw0, hw1, mask0=None, mask1=None):
        loftr = self.config.block_type == "loftr"
        dt = transformer_dtype(feat0.device, self.training)
        tab = table_dtype(feat0.device)
        rel = None
        if not loftr and self.config.relative_pe:
            if tuple(hw0) != tuple(hw1):
                raise ValueError(
                    "the 1/8 stack's relative PE is built on image0's grid "
                    f"{tuple(hw0)} for both images (as in the JAX package, "
                    f"which cannot run another grid {tuple(hw1)})")
            rel = self.relative_biases(hw0)
        rm = remats(self)
        for layer, name in zip(self.layers, self.config.layer_names):
            def call(*args, **kwargs):
                return layer_call(layer, rm, *args, **kwargs)

            if loftr:
                if name == "self":
                    feat0 = call(feat0, feat0, mask0, mask0, dt)
                    feat1 = call(feat1, feat1, mask1, mask1, dt)
                else:
                    feat0 = call(feat0, feat1, mask0, mask1, dt)
                    feat1 = call(feat1, feat0, mask1, mask0, dt)
            elif name == "self":
                feat0 = call(feat0, feat0, hw0, hw0, dt, tab, rel_pos=rel)
                feat1 = call(feat1, feat1, hw1, hw1, dt, tab, rel_pos=rel)
            else:
                feat0, feat1 = (
                    call(feat0, feat1, hw0, hw1, dt, tab, rel_pos=rel),
                    call(feat1, feat0, hw1, hw0, dt, tab, rel_pos=rel))
        return feat0.float(), feat1.float()
