"""Conv/BatchNorm building blocks that the Twins FPN shares with the ResNet
FPN family (counterpart of the helpers in
casmtr_tpu/models/backbone/resnet_fpn.py).  ``ResNetFPN_8_4_2`` itself is
not ported yet (ROADMAP queue A: ResNetFPN_8_4_2)."""

from __future__ import annotations

import torch.nn as nn


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False)


def conv3x3(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_planes, out_planes, 3, stride=stride, padding=1,
                     bias=False)


def bn(planes: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(planes, eps=1e-5)


def out_conv2(mid: int, out: int) -> nn.Sequential:
    """conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3 -> BN (indices 0, 1, 3, 4
    hold the parameters, as in the reference's FPN)."""
    return nn.Sequential(conv3x3(mid, mid), bn(mid), nn.LeakyReLU(0.01),
                         conv3x3(mid, out), bn(out))
