"""The ResNet-FPN backbones ``ResNetFPN_8_4_2``, ``ResNetFPN_8_2`` and
``ResNetFPN_16_4``, the PMT-refine side network ``Ladder_4_2``, the
Conv/BatchNorm building blocks that the Twins FPN shares with them, and the
backbone's compute dtype (counterpart of
casmtr_tpu/models/backbone/resnet_fpn.py). Layout NCHW in and out; module
names follow the JAX package's flax names as
``weights.flax_path_to_torch_key`` maps them (``layer1_0`` -> ``layer1.0``,
``downsample_0`` -> ``downsample.0``, ``layer2_outconv2/0`` ->
``layer2_outconv2.0``)."""

from __future__ import annotations

import os
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from casmtr_tpu_torch.models.precision import run
from casmtr_tpu_torch.ops.image_ops import resize_bilinear_align_corners
from casmtr_tpu_torch.parallel import mesh


def backbone_dtype(device: torch.device, train: bool) -> torch.dtype:
    """The backbone's compute dtype: bfloat16 on the card and float32 on
    the CPU, in eval and in training alike (``train`` does not change it),
    as the JAX package computes its backbone in bf16 on its TPU in both
    modes.  ``CASMTR_BACKBONE_BF16=0/1`` forces float32 or bfloat16.
    Parameters and BatchNorm statistics stay float32 (in training the batch
    statistics come from the bf16 activations widened to float32, as
    flax's), and the backbone returns float32 maps."""
    forced = os.environ.get("CASMTR_BACKBONE_BF16")
    if forced is not None:
        return torch.bfloat16 if forced == "1" else torch.float32
    cuda = torch.device(device).type == "cuda"
    return torch.bfloat16 if cuda else torch.float32


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False)


def conv3x3(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 3, stride=stride, padding=1,
                     bias=False)


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalization over the global batch of a group:
    the mean from all-reduced sums of x and the count, the biased variance
    from all-reduced sums of the squared deviations from it (two passes,
    as ``torch.var_mean``); the backward all-reduces the two gradient sums
    (of dy and of dy * x_hat), so each rank's dx carries every rank's loss
    share.  The parameter gradients are the rank's own sums: the step sums
    them over the group.  Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, grp):
        C = x.shape[1]
        n_local = x.numel() // C
        s = torch.cat([x.sum(dim=(0, 2, 3)),
                       x.new_full((1,), float(n_local))])
        s = mesh.all_reduce_sum(s, grp)
        n = s[C]
        mean = s[:C] / n
        xc = x - mean[None, :, None, None]
        var = mesh.all_reduce_sum((xc * xc).sum(dim=(0, 2, 3)), grp) / n
        invstd = torch.rsqrt(var + eps)
        x_hat = xc * invstd[None, :, None, None]
        ctx.save_for_backward(x_hat, invstd, weight, n)
        ctx.grp = grp
        y = x_hat * weight[None, :, None, None] + bias[None, :, None, None]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, invstd, weight, n = ctx.saved_tensors
        C = dy.shape[1]
        local = torch.cat([dy.sum(dim=(0, 2, 3)),
                           (dy * x_hat).sum(dim=(0, 2, 3))])
        g = mesh.all_reduce_sum(local, ctx.grp)
        dx = (weight * invstd)[None, :, None, None] * (
            dy - (g[:C] / n)[None, :, None, None]
            - x_hat * (g[C:] / n)[None, :, None, None])
        return dx, local[C:], local[:C], None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (flax's) running statistics.  In
    training it normalizes with the batch statistics as torch's does, but
    moves the running variance toward the BIASED batch variance (flax's
    momentum 0.9 on the running value is torch's 0.1 on the batch value);
    torch's own module moves it toward the unbiased one.  Inside
    ``parallel.mesh.global_batch()`` the batch is the group's global batch
    (``_GlobalBatchNorm``), as flax's BatchNorm under the JAX step's
    sharded jit.  Eval mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x in float32: ``precision.run`` widens a bf16 input first, so the
        statistics are taken in float32."""
        if not self.training:
            return super().forward(x)
        grp = mesh.batch_group()
        if grp is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                                  self.eps, grp)
            with torch.no_grad():
                self._track(mean, var)
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._track(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)


def bn(planes: int) -> BatchNorm2d:
    return BatchNorm2d(planes, eps=1e-5)


def out_conv2(mid: int, out: int) -> nn.Sequential:
    """conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3 -> BN (indices 0, 1, 3, 4
    hold the parameters, as in the reference's FPN)."""
    return nn.Sequential(conv3x3(mid, mid), bn(mid), nn.LeakyReLU(0.01),
                         conv3x3(mid, out), bn(out))


class BasicBlock(nn.Module):
    """Two-conv residual unit; a strided one projects its shortcut with a
    strided 1x1 conv and BatchNorm (``downsample``)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.bn1 = bn(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = bn(planes)
        self.downsample = (nn.Sequential(conv1x1(in_planes, planes, stride),
                                         bn(planes))
                           if stride != 1 else None)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        dt = dtype or x.dtype
        x = x.to(dt)
        y = F.relu(run(self.bn1, run(self.conv1, x, dt), dt))
        y = run(self.bn2, run(self.conv2, y, dt), dt)
        if self.downsample is not None:
            x = run(self.downsample, x, dt)
        return F.relu(x + y)


def _out_conv2(mid: int, out: int) -> nn.Sequential:
    """conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3 (indices 0, 1, 3 hold
    the parameters; no BatchNorm after the second conv, unlike the Twins
    FPN's ``out_conv2``)."""
    return nn.Sequential(conv3x3(mid, mid), bn(mid), nn.LeakyReLU(0.01),
                         conv3x3(mid, out))


def _to_gray(x: torch.Tensor) -> torch.Tensor:
    """RGB [B, 3, H, W] -> luma [B, 1, H, W]."""
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


class ResNetFPN_8_4_2(nn.Module):
    """The stem (7x7 conv, stride 2, padding 3), three stages of two
    BasicBlocks (1/2, 1/4, 1/8) and the FPN's top-down fusion.  Input
    [B, 3, H, W] in [0, 1] (RGB, turned to gray unless ``is_rgb``) or
    [B, 1, H, W].  Computes in ``backbone_dtype(device, self.training)``;
    returns [1/8 (block_dims[2]), 1/4 (block_dims[1]), 1/2 (block_dims[0])]
    NCHW float32 maps."""

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256),
                 is_rgb: bool = False):
        super().__init__()
        d = tuple(block_dims)
        self.is_rgb = is_rgb
        self.conv1 = nn.Conv2d(3 if is_rgb else 1, initial_dim, 7, stride=2,
                               padding=3, bias=False)
        self.bn1 = bn(initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(initial_dim, d[0]),
                                    BasicBlock(d[0], d[0]))
        self.layer2 = nn.Sequential(BasicBlock(d[0], d[1], 2),
                                    BasicBlock(d[1], d[1]))
        self.layer3 = nn.Sequential(BasicBlock(d[1], d[2], 2),
                                    BasicBlock(d[2], d[2]))
        self.layer3_outconv = conv1x1(d[2], d[2])
        self.layer2_outconv = conv1x1(d[1], d[2])
        self.layer2_outconv2 = _out_conv2(d[2], d[1])
        self.layer1_outconv = conv1x1(d[0], d[1])
        self.layer1_outconv2 = _out_conv2(d[1], d[0])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if not self.is_rgb and x.shape[1] == 3:
            x = _to_gray(x)
        dt = backbone_dtype(x.device, self.training)
        x1 = F.relu(run(self.bn1, run(self.conv1, x, dt), dt))
        for blk in self.layer1:
            x1 = blk(x1, dt)                                  # 1/2
        x2 = x1
        for blk in self.layer2:
            x2 = blk(x2, dt)                                  # 1/4
        x3 = x2
        for blk in self.layer3:
            x3 = blk(x3, dt)                                  # 1/8
        x3_out = run(self.layer3_outconv, x3, dt)
        x3_2x = resize_bilinear_align_corners(x3_out, *x2.shape[-2:])
        x2_out = run(self.layer2_outconv2,
                     run(self.layer2_outconv, x2, dt) + x3_2x, dt)
        x2_2x = resize_bilinear_align_corners(x2_out, *x1.shape[-2:])
        x1_out = run(self.layer1_outconv2,
                     run(self.layer1_outconv, x1, dt) + x2_2x, dt)
        return [x3_out.float(), x2_out.float(), x1_out.float()]


class ResNetFPN_8_2(ResNetFPN_8_4_2):
    """The same network and parameters, returning only the [1/8, 1/2]
    maps."""

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x3_out, _, x1_out = super().forward(x)
        return [x3_out, x1_out]


class ResNetFPN_16_4(nn.Module):
    """The stem and four stages of two BasicBlocks (1/2, 1/4, 1/8, 1/16) and
    the FPN's top-down fusion from 1/16 to 1/4.  Input as
    ``ResNetFPN_8_4_2``'s; computes in ``backbone_dtype(device,
    self.training)``; returns [1/16 (block_dims[3]), 1/4 (block_dims[1])]
    NCHW float32 maps."""

    def __init__(self, initial_dim: int = 128,
                 block_dims=(128, 196, 256, 512), is_rgb: bool = False):
        super().__init__()
        d = tuple(block_dims)
        self.is_rgb = is_rgb
        self.conv1 = nn.Conv2d(3 if is_rgb else 1, initial_dim, 7, stride=2,
                               padding=3, bias=False)
        self.bn1 = bn(initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(initial_dim, d[0]),
                                    BasicBlock(d[0], d[0]))
        self.layer2 = nn.Sequential(BasicBlock(d[0], d[1], 2),
                                    BasicBlock(d[1], d[1]))
        self.layer3 = nn.Sequential(BasicBlock(d[1], d[2], 2),
                                    BasicBlock(d[2], d[2]))
        self.layer4 = nn.Sequential(BasicBlock(d[2], d[3], 2),
                                    BasicBlock(d[3], d[3]))
        self.layer4_outconv = conv1x1(d[3], d[3])
        self.layer3_outconv = conv1x1(d[2], d[3])
        self.layer3_outconv2 = _out_conv2(d[3], d[2])
        self.layer2_outconv = conv1x1(d[1], d[2])
        self.layer2_outconv2 = _out_conv2(d[2], d[1])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if not self.is_rgb and x.shape[1] == 3:
            x = _to_gray(x)
        dt = backbone_dtype(x.device, self.training)
        x = F.relu(run(self.bn1, run(self.conv1, x, dt), dt))
        stages = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for blk in layer:
                x = blk(x, dt)
            stages.append(x)                          # 1/2, 1/4, 1/8, 1/16
        _, x2, x3, x4 = stages
        x4_out = run(self.layer4_outconv, x4, dt)
        x4_2x = resize_bilinear_align_corners(x4_out, *x3.shape[-2:])
        x3_out = run(self.layer3_outconv2,
                     run(self.layer3_outconv, x3, dt) + x4_2x, dt)
        x3_2x = resize_bilinear_align_corners(x3_out, *x2.shape[-2:])
        x2_out = run(self.layer2_outconv2,
                     run(self.layer2_outconv, x2, dt) + x3_2x, dt)
        return [x4_out.float(), x2_out.float()]


class Ladder_4_2(nn.Module):
    """The trainable side network of the PMT-refine model: a stem and two
    stages of two BasicBlocks (1/2, 1/4) at ``refine_dims``, fused with the
    frozen trunk's 1/4 and 1/2 maps (``block_dims[1]``, ``block_dims[0]``
    channels), which it takes detached.  Input [B, 3, H, W] in [0, 1] (RGB,
    turned to gray unless ``is_rgb``) or [B, 1, H, W].  ``bn_fix`` adds a
    BatchNorm after the 1/2 lateral conv (``layer1_outconv.0/1``; without
    it the conv alone is ``layer1_outconv``).  Computes in
    ``backbone_dtype(device, self.training)``; returns [1/4
    (refine_dims[1]), 1/2 (refine_dims[0])] NCHW float32 maps."""

    def __init__(self, block_dims=(128, 196, 256),
                 refine_dims=(64, 128, 256), is_rgb: bool = False,
                 bn_fix: bool = False):
        super().__init__()
        rd, bd = tuple(refine_dims), tuple(block_dims)
        self.is_rgb = is_rgb
        self.conv1 = nn.Conv2d(3 if is_rgb else 1, rd[0], 7, stride=2,
                               padding=3, bias=False)
        self.bn1 = bn(rd[0])
        self.layer1 = nn.Sequential(BasicBlock(rd[0], rd[0]),
                                    BasicBlock(rd[0], rd[0]))
        self.layer2 = nn.Sequential(BasicBlock(rd[0], rd[1], 2),
                                    BasicBlock(rd[1], rd[1]))
        self.layer2_outconv = nn.Sequential(conv1x1(rd[1] + bd[1], rd[1]),
                                            bn(rd[1]))
        lateral = conv1x1(rd[0] + bd[0], rd[1])
        self.layer1_outconv = (nn.Sequential(lateral, bn(rd[1])) if bn_fix
                               else lateral)
        self.layer1_outconv2 = out_conv2(rd[1], rd[0])

    def forward(self, x: torch.Tensor, add_feats) -> List[torch.Tensor]:
        """add_feats: the trunk's [1/4, 1/2] NCHW maps."""
        if not self.is_rgb and x.shape[1] == 3:
            x = _to_gray(x)
        dt = backbone_dtype(x.device, self.training)
        x1 = F.relu(run(self.bn1, run(self.conv1, x, dt), dt))
        for blk in self.layer1:
            x1 = blk(x1, dt)                                  # 1/2
        x2 = x1
        for blk in self.layer2:
            x2 = blk(x2, dt)                                  # 1/4
        f4, f2 = (f.detach().to(dt) for f in add_feats)
        x2_out = run(self.layer2_outconv, torch.cat([x2, f4], dim=1), dt)
        x2_2x = resize_bilinear_align_corners(x2_out, *x1.shape[-2:])
        x1_out = run(self.layer1_outconv, torch.cat([x1, f2], dim=1), dt)
        x1_out = run(self.layer1_outconv2, x1_out + x2_2x, dt)
        return [x2_out.float(), x1_out.float()]
