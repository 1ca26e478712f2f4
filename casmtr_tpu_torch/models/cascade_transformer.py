"""Cascade-stage transformer: window cross attention around the previous
stage's matches (counterpart of casmtr_tpu/models/cascade_transformer.py:
the self-attention zoo -- 'local', 'local_global', 'LKA', 'linear',
'topk' (Guided quadtree attention on the 1/8 cycle top-k) and 'POLA' --,
the 'window' and 'dilated1' propagations, the indoor recipe's windowed
relative PE, and the learnable keypoint detector head).  The stack
computes in ``transformer_dtype`` (the POLA and LKA blocks in float32, as
the JAX package's), feeds the cross layers and the Guided layers q/k/v in
``table_dtype`` and returns float32 tokens for window matching.  With
``remat`` every layer but the LKA blocks (which hold BatchNorm) runs
under ``transformer.layer_call`` in training, as the JAX package wraps
its blocks in ``nn.remat``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from casmtr_tpu_torch.models.backbone.resnet_fpn import bn
from casmtr_tpu_torch.models.cascade_attention import (DoubleGroupBlock,
                                                       LKABlock, LocalBlock)
from casmtr_tpu_torch.models.pola import POLATransBlock
from casmtr_tpu_torch.models.precision import run
from casmtr_tpu_torch.models.transformer import (LoFTREncoderLayer, Mlp,
                                                 QuadtreeBlock, layer_call,
                                                 remats, table_dtype,
                                                 transformer_dtype)
from casmtr_tpu_torch.ops.propagation import get_propagations
from casmtr_tpu_torch.ops.quadtree import (GUIDED_LEVELS, cascade_qtatt_b,
                                           topk_lowest_first,
                                           unblock_children)

SELF_ATTN_TYPES = ("local", "local_global", "LKA", "linear", "topk", "POLA")


def window_warp_idx(idx: torch.Tensor, window: np.ndarray, h: int, w: int,
                    full_window: Optional[np.ndarray] = None):
    """Previous-stage match indices [B, HW] on the (h, w) grid -> window
    positions [B, HW, ww, 2] (y, x); a window crossing a border is shifted
    inward as a whole.  With ``full_window`` (the dilated propagation's
    dense square) returns (window positions, full-window positions
    [B, HW, fw, 2] shifted as their window)."""
    pos = torch.stack([torch.div(idx, w, rounding_mode="floor"), idx % w],
                      dim=-1)                                # [B, HW, 2]
    win = torch.as_tensor(window, dtype=pos.dtype, device=pos.device)
    idx_yx = pos[:, :, None, :] + win[None, None]            # [B, HW, ww, 2]
    under = idx_yx.min(dim=2, keepdim=True).values.clamp(max=0)
    over = idx_yx.max(dim=2, keepdim=True).values
    over_y = (over[..., 0] - (h - 1)).clamp(min=0)
    over_x = (over[..., 1] - (w - 1)).clamp(min=0)
    shift = under + torch.stack([over_y, over_x], dim=-1)
    if full_window is None:
        return idx_yx - shift
    full = torch.as_tensor(full_window, dtype=pos.dtype, device=pos.device)
    return idx_yx - shift, pos[:, :, None, :] + full[None, None] - shift


def upsample_idx(topk_pos: torch.Tensor, h0: int, h1: int, w1: int
                 ) -> torch.Tensor:
    """2x index dilation of a window position set: topk_pos [B, P, K, 2]
    (y, x) on image1's (h1, w1) half grid, P the parents of image0's
    (2 h0)-row grid -> flat candidate indices [B, 4P, 4K] on image1's
    (2 h1, 2 w1) grid, each window position's 2x2 children in order
    (dr, dc), clamped into the grid, shared by each parent's children."""
    B, P, K, _ = topk_pos.shape
    pos = topk_pos * 2
    idx = torch.stack([(pos[..., 0] + dr) * (w1 * 2) + pos[..., 1] + dc
                       for dr in (0, 1) for dc in (0, 1)], dim=3)
    idx = idx.reshape(B, P, K * 4).clamp(0, 4 * h1 * w1 - 1)
    idx = idx[:, :, None].expand(B, P, 4, K * 4)
    return unblock_children(idx, h0, P // h0)


class CascadeQuadtreeAttention(nn.Module):
    """q/k/v projections around ``cascade_qtatt_b`` and the output
    projection; with a relative position bias ``rel_pos`` [B, H, L, 4Kw]
    the attention takes the gather path, else kernel C."""

    def __init__(self, dim: int, num_heads: int, dilated: int = 1,
                 window_structured: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dilated = dilated
        self.window_structured = window_structured
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, target, hw_x, hw_t, idx, dtype=None, tables=None,
                rel_pos=None):
        """Computes in ``dtype`` (default: x's); the attention reads q/k/v
        cast to ``tables`` (default: float32)."""
        B, L, C = x.shape
        dt = dtype or x.dtype
        tab = tables or torch.float32
        D = C // self.num_heads
        q = run(self.q_proj, x, dt).to(tab).reshape(B, L, self.num_heads, D)
        k = run(self.k_proj, target, dt).to(tab).reshape(B, -1,
                                                         self.num_heads, D)
        v = run(self.v_proj, target, dt).to(tab).reshape(B, -1,
                                                         self.num_heads, D)
        msg, up_idx = cascade_qtatt_b(q, k, v, idx, hw_x, hw_t,
                                      dilated=self.dilated, rel_pos=rel_pos,
                                      window_structured=self.window_structured)
        return run(self.proj, msg.reshape(B, L, C), dt), up_idx


class CascadeQuadtreeBlock(nn.Module):
    """PreNorm cascade cross-attention + DWConv-MLP; norm1 shared by x and
    target."""

    def __init__(self, dim: int, num_heads: int, dilated: int = 1,
                 mlp_ratio: float = 4.0, window_structured: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = CascadeQuadtreeAttention(dim, num_heads, dilated,
                                             window_structured)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, target, hw_x, hw_t, idx, dtype=None, tables=None,
                rel_pos=None):
        dt = dtype or x.dtype
        x, target = x.to(dt), target.to(dt)
        y, up_idx = self.attn(run(self.norm1, x, dt),
                              run(self.norm1, target, dt), hw_x, hw_t, idx,
                              dt, tables, rel_pos)
        x = x + y
        return (x + self.mlp(run(self.norm2, x, dt), hw_x[0], hw_x[1], dt),
                up_idx)


class CascadeFeatureTransformer(nn.Module):
    """Cascade-level transformer: self layers of ``self_attn_type`` and
    window cross layers; cross layers update both images simultaneously.
    The self layers: 'local' (LocalBlock), 'local_global'
    (DoubleGroupBlock with ``sr_ratio``), 'POLA', 'LKA' (LKABlock, batch
    statistics in training), 'linear' (LoFTREncoderLayer with linear
    attention, no masks) and 'topk' (a one-level Guided QuadtreeBlock whose
    guide is the cycle-consistent top-``topks[0]`` of the 1/8 confidence
    matrix, ``_cycle_topk``).  Propagation 'window' at dilation 1 gives the
    structured windows of kernels B and C; 'dilated1' (or a dilation) takes
    the gather paths, and the candidates of window matching are the
    upsampled full window.  With ``relative_pe`` the cross layers add the
    windowed relative position bias of ``h_pos_bias`` and ``w_pos_bias``.
    With ``detector`` 'learnable' a head ``detector`` (3x3 conv,
    BatchNorm, SiLU, 1x1 conv, in float32) maps image0's output tokens to
    a keypoint heatmap in training.  ``remat``: the layers but LKABlock
    under ``layer_call`` in training (``remats``); the detector head is
    never recomputed."""

    def __init__(self, config, remat: bool = True):
        super().__init__()
        self.config = config
        self.remat = remat
        t = config.self_attn_type
        if "self" in config.layer_names:
            if t not in SELF_ATTN_TYPES:
                raise NotImplementedError(f"cascade self-attention {t!r}")
            if t == "topk" and len(config.topks or ()) != 1:
                raise ValueError(f"{GUIDED_LEVELS}; self_attn_type 'topk' "
                                 f"with topks {config.topks}")
        if config.detector not in (None, "learnable"):
            raise NotImplementedError(f"detector {config.detector!r}")
        self.window, self.full_window = get_propagations(
            config.propagation, config.window_size, config.dilated)
        aws = config.attn_window_size or config.window_size
        self.structured = (config.propagation == "window"
                           and config.dilated == 1)
        d, nh = config.d_model, config.nhead

        def self_layer():
            if t == "POLA":
                return POLATransBlock(d, nh, aws)
            if t == "local_global":
                return DoubleGroupBlock(d, nh, 4.0, config.sr_ratio, aws)
            if t == "LKA":
                return LKABlock(d, 4.0)
            if t == "linear":
                return LoFTREncoderLayer(d, nh, "linear")
            if t == "topk":
                return QuadtreeBlock(d, nh, config.topks, 1,
                                     attn_type="Guided")
            return LocalBlock(d, nh, 4.0, aws)

        self.layers = nn.ModuleList(
            self_layer() if name == "self" else
            CascadeQuadtreeBlock(d, nh, dilated=config.dilated,
                                 window_structured=self.structured)
            for name in config.layer_names)
        if config.relative_pe:
            # LB: the offset range of the windowed relative PE
            self.LB = config.window_size * (2 if config.sr_ratio == 2 else 6)
            n = self.LB * 2 + config.sr_ratio
            self.h_pos_bias = nn.Embedding(n, config.nhead)
            self.w_pos_bias = nn.Embedding(n, config.nhead)
        self.detector = (nn.Sequential(nn.Conv2d(d, d, 3, padding=1), bn(d),
                                       nn.SiLU(), nn.Conv2d(d, 1, 1))
                         if config.detector == "learnable" else None)

    def _cycle_topk(self, conf_matrix: torch.Tensor):
        """The Guided layers' guides from the 1/8 confidence matrix
        [B, L0, L1]: for each cell of image0's 1/8 grid, the top-k cells of
        image0 of its best match's row of the reverse top-k table (and
        likewise for image1), k = ``topks[0]``, ties to the lower index
        (the JAX package's CPU top-k); [B, L, k, nhead] int32, one guide
        row per 1/8 cell."""
        k = self.config.topks[0]
        with torch.no_grad():
            ti01 = topk_lowest_first(conf_matrix, k, 2)[1]       # [B, L0, k]
            ti10 = topk_lowest_first(conf_matrix.transpose(1, 2), k, 2)[1]
            cyc0 = torch.gather(ti10, 1, ti01[:, :, :1].expand(-1, -1, k))
            cyc1 = torch.gather(ti01, 1, ti10[:, :, :1].expand(-1, -1, k))
        nh = self.config.nhead
        return tuple(c[..., None].expand(*c.shape, nh).to(torch.int32)
                     .contiguous() for c in (cyc0, cyc1))

    def _relative_pe(self, hw_c_q, hw_c_t, next_idx_c, window_idx, H: int,
                     W: int) -> torch.Tensor:
        """The windowed relative PE [B, nhead, H*W, 4ww] of a query image at
        this level (H, W): for each query cell and each candidate of its
        window, the offset between the candidate and the query's 1/8 match
        (``next_idx_c`` [B, h*w] on the target's 1/8 grid ``hw_c_t``) plus
        the query's place inside its 1/8 cell, both (x, y), shifted by LB
        and 2 LB, clipped into the tables, through ``w_pos_bias`` (x) and
        ``h_pos_bias`` (y).  window_idx: [B, (H/2)*(W/2), ww, 2] (y, x) on
        the target's 2x coarser grid of this level."""
        h, w = hw_c_q
        w1 = hw_c_t[1]
        s = H // h
        W1 = w1 * s
        B = next_idx_c.shape[0]
        LB = self.LB
        dev = next_idx_c.device
        ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        # (x, y) place of each cell inside its 1/8 cell
        src = torch.stack([xs % s, ys % s], -1)[None, :, None]  # [1, HW, 1, 2]
        # the 1/8 match of each cell's 1/8 cell, at this level's scale
        nxt = next_idx_c[:, (ys // s) * w + xs // s]            # [B, HW]
        tgt = torch.stack([nxt % w1, nxt // w1], -1) * s + (s // 2 - 1)
        # each cell's window candidates on the target's grid, (x, y)
        wi = window_idx * 2
        cands = torch.stack([(wi[..., 0] + dr) * W1 + wi[..., 1] + dc
                             for dr in (0, 1) for dc in (0, 1)], dim=3)
        cands = cands.reshape(B, cands.shape[1], -1)         # [B, HW/4, 4ww]
        cands = cands[:, (ys // 2) * (W // 2) + xs // 2]     # [B, HW, 4ww]
        wi = torch.stack([cands % W1, cands // W1], -1)      # [B, HW, 4ww, 2]
        rel = src - (tgt[:, :, None] - wi + LB) + 2 * LB
        rel = rel.clamp(0, self.w_pos_bias.num_embeddings - 1)
        bias = self.w_pos_bias(rel[..., 0]) + self.h_pos_bias(rel[..., 1])
        return bias.permute(0, 3, 1, 2)                      # [B, nh, HW, 4ww]

    def forward(self, feat0, feat1, idx_c01, idx_c10, hw0: Tuple[int, int],
                hw1: Tuple[int, int], hw0_c=None, hw1_c=None,
                next_idx_c01=None, next_idx_c10=None, conf_matrix_c=None):
        """feat0/feat1: [B, L, C] at this level; idx_c01/idx_c10: [B, L/4]
        previous-stage best-match indices on the TARGET image's 2x coarser
        grid; with ``relative_pe`` also the 1/8 grids hw0_c/hw1_c and the
        1/8 best matches next_idx_c01/next_idx_c10 [B, h*w]; with 'topk'
        self layers the 1/8 confidence matrix ``conf_matrix_c``
        [B, h0*w0, h1*w1].  Returns (feat0, feat1 float32, idx_c01
        [B, L0, 4ww] (the upsampled full window with 'dilated1'), idx_c10,
        corners01 [B, L0/4, 2] and corners10 of the structured windows or
        None, heatmap0 [B, H0, W0] float32 from the detector head in
        training, else None)."""
        H0, W0 = hw0
        H1, W1 = hw1
        cfg = self.config
        dt = transformer_dtype(feat0.device, self.training)
        tab = table_dtype(feat0.device)
        fw = self.full_window
        win01 = window_warp_idx(idx_c01, self.window, H1 // 2, W1 // 2, fw)
        win10 = window_warp_idx(idx_c10, self.window, H0 // 2, W0 // 2, fw)
        if fw is not None:
            (win01, full01), (win10, full10) = win01, win10
        rel01 = rel10 = None
        if cfg.relative_pe:
            rel01 = self._relative_pe(hw0_c, hw1_c, next_idx_c01, win01, H0,
                                      W0)
            rel10 = self._relative_pe(hw1_c, hw0_c, next_idx_c10, win10, H1,
                                      W1)
        guides = None
        up01 = up10 = None
        rm = remats(self)
        for layer, name in zip(self.layers, cfg.layer_names):
            wrap = rm and not isinstance(layer, LKABlock)

            def call(*args, **kwargs):
                return layer_call(layer, wrap, *args, **kwargs)
            if name != "self":
                (feat0, up01), (feat1, up10) = (
                    call(feat0, feat1, hw0, hw1, win01, dt, tab, rel01),
                    call(feat1, feat0, hw1, hw0, win10, dt, tab, rel10))
            elif isinstance(layer, (POLATransBlock, LKABlock)):
                feat0, feat1 = call(feat0, H0, W0), call(feat1, H1, W1)
            elif isinstance(layer, LoFTREncoderLayer):
                feat0 = call(feat0, feat0, None, None, dt)
                feat1 = call(feat1, feat1, None, None, dt)
            elif isinstance(layer, QuadtreeBlock):
                if guides is None:
                    guides = self._cycle_topk(conf_matrix_c)
                feat0 = call(feat0, feat0, hw0, hw0, dt, tab,
                             topk_pos=guides[0])
                feat1 = call(feat1, feat1, hw1, hw1, dt, tab,
                             topk_pos=guides[1])
            else:
                feat0 = call(feat0, H0, W0, dt)
                feat1 = call(feat1, H1, W1, dt)
        feat0, feat1 = feat0.float(), feat1.float()
        if fw is not None:
            up01 = upsample_idx(full01, H0 // 2, H1 // 2, W1 // 2)
            up10 = upsample_idx(full10, H1 // 2, H0 // 2, W0 // 2)
        corners01 = win01[:, :, 0, :] if self.structured else None
        corners10 = win10[:, :, 0, :] if self.structured else None
        heat0 = None
        if self.detector is not None and self.training:
            grid = feat0.transpose(1, 2).reshape(feat0.shape[0], -1, H0, W0)
            heat0 = self.detector(grid)[:, 0]
        return feat0, feat1, up01, up10, corners01, corners10, heat0
