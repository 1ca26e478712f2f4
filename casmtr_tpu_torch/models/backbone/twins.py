"""Twins-SVT backbone + FPN (counterpart of
casmtr_tpu/models/backbone/twins.py: PatchEmbed, PosCNN, TwinsSVT,
FPNBasicBlock, TwinsFPN_8_4_2, TwinsFPN_16_8_4_2).  Layout NCHW in and
out.  The whole backbone computes in ``backbone_dtype`` (models/precision.py
casts each step) and returns float32 maps.

The strided patch-embedding and spatial-reduction convs use padding 0, which
floors the grid -- the shapes and values of the JAX package's VALID padding.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from casmtr_tpu_torch.models.backbone.resnet_fpn import (backbone_dtype, bn,
                                                         conv1x1, conv3x3,
                                                         out_conv2)
from casmtr_tpu_torch.models.cascade_attention import GroupBlock
from casmtr_tpu_torch.models.precision import run
from casmtr_tpu_torch.ops.image_ops import resize_bilinear_align_corners

# size presets: embed_dims, num_heads, depths, wss, sr_ratios
TWINS_PRESETS = {
    "small": dict(embed_dims=(64, 128, 256, 512), num_heads=(2, 4, 8, 16),
                  depths=(2, 2, 10, 4), wss=(7, 7, 7, 7), sr_ratios=(8, 4, 2, 1)),
    "base": dict(embed_dims=(96, 192, 384, 768), num_heads=(3, 6, 12, 24),
                 depths=(2, 2, 18, 2), wss=(7, 7, 7, 7), sr_ratios=(8, 4, 2, 1)),
    "large": dict(embed_dims=(128, 256, 512, 1024), num_heads=(4, 8, 16, 32),
                  depths=(2, 2, 18, 2), wss=(7, 7, 7, 7), sr_ratios=(8, 4, 2, 1)),
}

_LN_EPS = 1e-6  # the Twins block norms


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding + LayerNorm."""

    def __init__(self, in_dim: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_dim, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, dtype=None):
        dt = dtype or x.dtype
        x = run(self.proj, x, dt)
        H, W = x.shape[-2:]
        return run(self.norm, x.flatten(2).transpose(1, 2), dt), (H, W)


class PosCNN(nn.Module):
    """Conditional position encoding: depthwise 3x3 conv + residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x: torch.Tensor, h: int, w: int,
                dtype=None) -> torch.Tensor:
        B, N, C = x.shape
        xi = x.transpose(1, 2).reshape(B, C, h, w).to(dtype or x.dtype)
        return (run(self.proj, xi, xi.dtype) + xi).flatten(2).transpose(1, 2)


class TwinsSVT(nn.Module):
    """Twins-SVT truncated to its first ``n_stages`` stages.  Blocks alternate
    window attention (even index) and global sr attention (odd); PosCNN
    follows the first block of each stage; each stage ends in a LayerNorm.
    A third stage is cut to two blocks, whatever the preset's depth (the
    reference's first3_layers variants all pass stage3_depth 2, as the JAX
    module does).  Returns the stage outputs NCHW, in ``dtype`` (default:
    x's)."""

    def __init__(self, model_type: str = "large", n_stages: int = 2):
        super().__init__()
        pre = TWINS_PRESETS[model_type]
        dims = pre["embed_dims"]
        depths = [2 if i == 2 else pre["depths"][i] for i in range(n_stages)]
        self.patch_embeds = nn.ModuleList(
            PatchEmbed(3 if i == 0 else dims[i - 1], dims[i], 4 if i == 0 else 2)
            for i in range(n_stages))
        self.blocks = nn.ModuleList(
            nn.ModuleList(
                GroupBlock(dims[i], pre["num_heads"][i], 4.0,
                           pre["sr_ratios"][i],
                           1 if j % 2 == 1 else pre["wss"][i],
                           qkv_bias=True, ln_eps=_LN_EPS)
                for j in range(depths[i]))
            for i in range(n_stages))
        self.pos_block = nn.ModuleList(PosCNN(dims[i]) for i in range(n_stages))
        self.norm_list = nn.ModuleList(nn.LayerNorm(dims[i], eps=_LN_EPS)
                                       for i in range(n_stages))

    def forward(self, x: torch.Tensor, dtype=None) -> List[torch.Tensor]:
        dt = dtype or x.dtype
        outputs = []
        for i, embed in enumerate(self.patch_embeds):
            x, (H, W) = embed(x, dt)
            for j, blk in enumerate(self.blocks[i]):
                x = blk(x, H, W, dt)
                if j == 0:
                    x = self.pos_block[i](x, H, W, dt)
            x = run(self.norm_list[i], x, dt)
            x = x.transpose(1, 2).reshape(x.shape[0], -1, H, W)
            outputs.append(x)
        return outputs


class FPNBasicBlock(nn.Module):
    """Two-conv residual unit (stride 1) with a 1x1 projection shortcut when
    the channel count changes."""

    def __init__(self, in_planes: int, planes: int):
        super().__init__()
        self.conv1 = conv3x3(in_planes, planes)
        self.bn1 = bn(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = bn(planes)
        if in_planes != planes:
            self.shortcut = nn.Sequential(conv1x1(in_planes, planes), bn(planes))
        else:
            self.shortcut = nn.Identity()

    def forward(self, x, dtype=None):
        dt = dtype or x.dtype
        x = x.to(dt)
        y = F.relu(run(self.bn1, run(self.conv1, x, dt), dt))
        y = run(self.bn2, run(self.conv2, y, dt), dt)
        return F.relu(run(self.shortcut, x, dt) + y)


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class TwinsFPN_8_4_2(nn.Module):
    """Conv stem (1/2) + Twins ViT (1/4, 1/8) + FPN fusion.  Input: RGB in
    [0, 1], [B, 3, H, W] (ImageNet normalization inline).  Computes in
    ``backbone_dtype(device, self.training)``; returns [1/8 (bd[2]), 1/4
    (bd[1]), 1/2 (bd[0])] NCHW float32 maps."""

    def __init__(self, initial_dim: int = 64, block_dims=(64, 128, 256),
                 model_type: str = "large"):
        super().__init__()
        bd = tuple(block_dims)
        dims = TWINS_PRESETS[model_type]["embed_dims"]
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, bd[0] // 2, 7, stride=2, padding=3, bias=False),
            bn(bd[0] // 2), nn.ReLU())
        self.layer1 = nn.Sequential(FPNBasicBlock(bd[0] // 2, bd[0]),
                                    FPNBasicBlock(bd[0], bd[0]))
        self.vit = TwinsSVT(model_type, 2)
        self.layer3_outconv = nn.Sequential(conv1x1(dims[1], bd[2]), bn(bd[2]))
        self.layer2_outconv = nn.Sequential(conv1x1(dims[0], bd[2]), bn(bd[2]))
        self.layer2_outconv2 = out_conv2(bd[2], bd[1])
        self.layer1_outconv = nn.Sequential(conv1x1(bd[0], bd[1]), bn(bd[1]))
        self.layer1_outconv2 = out_conv2(bd[1], bd[0])
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN)[:, None, None],
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD)[:, None, None],
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = backbone_dtype(x.device, self.training)
        x = (x - self.mean) / self.std
        x1 = run(self.conv1, x, dt)
        for blk in self.layer1:
            x1 = blk(x1, dt)
        x2, x3 = self.vit(x, dt)
        x3_out = run(self.layer3_outconv, x3, dt)
        x3_2x = resize_bilinear_align_corners(x3_out, *x2.shape[-2:])
        x2_out = run(self.layer2_outconv2,
                     run(self.layer2_outconv, x2, dt) + x3_2x, dt)
        x2_2x = resize_bilinear_align_corners(x2_out, *x1.shape[-2:])
        x1_out = run(self.layer1_outconv2,
                     run(self.layer1_outconv, x1, dt) + x2_2x, dt)
        return [x3_out.float(), x2_out.float(), x1_out.float()]


class TwinsFPN_16_8_4_2(nn.Module):
    """Conv stem (1/2) + three-stage Twins ViT (1/4, 1/8, 1/16) + FPN fusion
    from 1/16 down to 1/2.  Input as ``TwinsFPN_8_4_2``'s; returns [1/16
    (bd[3]), 1/8 (bd[2]), 1/4 (bd[1]), 1/2 (bd[0])] NCHW float32 maps."""

    def __init__(self, initial_dim: int = 64, block_dims=(64, 128, 196, 256),
                 model_type: str = "large"):
        super().__init__()
        bd = tuple(block_dims)
        dims = TWINS_PRESETS[model_type]["embed_dims"]
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, bd[0] // 2, 7, stride=2, padding=3, bias=False),
            bn(bd[0] // 2), nn.ReLU())
        self.layer1 = nn.Sequential(FPNBasicBlock(bd[0] // 2, bd[0]),
                                    FPNBasicBlock(bd[0], bd[0]))
        self.vit = TwinsSVT(model_type, 3)
        self.layer4_outconv = nn.Sequential(conv1x1(dims[2], bd[3]), bn(bd[3]))
        self.layer3_outconv = nn.Sequential(conv1x1(dims[1], bd[3]), bn(bd[3]))
        self.layer3_outconv2 = out_conv2(bd[3], bd[2])
        self.layer2_outconv = nn.Sequential(conv1x1(dims[0], bd[2]), bn(bd[2]))
        self.layer2_outconv2 = out_conv2(bd[2], bd[1])
        self.layer1_outconv = nn.Sequential(conv1x1(bd[0], bd[1]), bn(bd[1]))
        self.layer1_outconv2 = out_conv2(bd[1], bd[0])
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN)[:, None, None],
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD)[:, None, None],
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        dt = backbone_dtype(x.device, self.training)
        x = (x - self.mean) / self.std
        x1 = run(self.conv1, x, dt)
        for blk in self.layer1:
            x1 = blk(x1, dt)
        x2, x3, x4 = self.vit(x, dt)
        out = run(self.layer4_outconv, x4, dt)
        maps = [out]
        for fine, lateral, fuse in (
                (x3, self.layer3_outconv, self.layer3_outconv2),
                (x2, self.layer2_outconv, self.layer2_outconv2),
                (x1, self.layer1_outconv, self.layer1_outconv2)):
            up = resize_bilinear_align_corners(out, *fine.shape[-2:])
            out = run(fuse, run(lateral, fine, dt) + up, dt)
            maps.append(out)
        return [m.float() for m in maps]
