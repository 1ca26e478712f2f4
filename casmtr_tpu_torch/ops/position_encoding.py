"""Normalized sinusoidal position encoding (counterpart of
casmtr_tpu/ops/position_encoding.py ``sine_pe_norm``/``add_sine_pe_norm``).

The encoding is a function of the grid shape only, built in numpy with the
reference's channel interleave (sin_x, cos_x, sin_y, cos_y at 0::4 .. 3::4).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def sine_pe_norm(d_model: int, h: int, w: int,
                 max_shape: Tuple[int, int]) -> np.ndarray:
    """PositionEncodingSineNorm: positions rescaled by max_shape / (h, w), so
    the encoding learned at train size transfers to other sizes.
    Returns [C, H, W] float32."""
    y_pos = np.cumsum(np.ones((h, w), np.float32), axis=0)[None] \
        * max_shape[0] / h
    x_pos = np.cumsum(np.ones((h, w), np.float32), axis=1)[None] \
        * max_shape[1] / w
    div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                 * (-math.log(10000.0) / (d_model // 2)))[:, None, None]
    pe = np.zeros((d_model, h, w), dtype=np.float32)
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return pe


def add_sine_pe_norm(x: torch.Tensor, max_shape: Tuple[int, int]
                     ) -> torch.Tensor:
    """x: [B, C, H, W] -> x + PE.  ``max_shape`` is ``train_size // stride``,
    not the image's own grid (casmtr.py normalizes by the training size)."""
    _, c, h, w = x.shape
    pe = torch.from_numpy(sine_pe_norm(c, h, w, max_shape)).to(x.device, x.dtype)
    return x + pe[None]
