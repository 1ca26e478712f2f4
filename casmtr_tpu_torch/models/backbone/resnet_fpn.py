"""Conv/BatchNorm building blocks that the Twins FPN shares with the ResNet
FPN family, and the backbone's compute dtype (counterpart of the helpers
and ``backbone_dtype`` in casmtr_tpu/models/backbone/resnet_fpn.py).
``ResNetFPN_8_4_2`` itself is not ported yet (ROADMAP queue A:
ResNetFPN_8_4_2)."""

from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F


def backbone_dtype(device: torch.device, train: bool) -> torch.dtype:
    """The backbone's compute dtype.  ``CASMTR_BACKBONE_BF16=0/1`` forces
    float32 or bfloat16; otherwise bfloat16 on the card in eval, float32 on
    the CPU and in training.  (The JAX package computes its backbone in bf16
    on its TPU in training too; the port trains in float32 until its bf16
    backward instances exist, ROADMAP queue A.)  Parameters and BatchNorm
    statistics stay float32, and the backbone returns float32 maps."""
    forced = os.environ.get("CASMTR_BACKBONE_BF16")
    if forced is not None:
        return torch.bfloat16 if forced == "1" else torch.float32
    cuda = torch.device(device).type == "cuda"
    return torch.bfloat16 if cuda and not train else torch.float32


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False)


def conv3x3(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 3, stride=stride, padding=1,
                     bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (flax's) running statistics.  In
    training it normalizes with the batch statistics as torch's does, but
    moves the running variance toward the BIASED batch variance (flax's
    momentum 0.9 on the running value is torch's 0.1 on the batch value);
    torch's own module moves it toward the unbiased one.  Eval mode is
    torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def bn(planes: int) -> BatchNorm2d:
    return BatchNorm2d(planes, eps=1e-5)


def out_conv2(mid: int, out: int) -> nn.Sequential:
    """conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3 -> BN (indices 0, 1, 3, 4
    hold the parameters, as in the reference's FPN)."""
    return nn.Sequential(conv3x3(mid, mid), bn(mid), nn.LeakyReLU(0.01),
                         conv3x3(mid, out), bn(out))
