"""One module step in a compute dtype: the port's counterpart of flax's
per-module ``dtype=`` (casmtr_tpu's bf16 policy).

Parameters and buffers stay float32.  Linear maps and convolutions cast
their input and weights to the compute dtype and round their product to it
before the bias is added, as flax's Dense and Conv do; LayerNorm and
BatchNorm normalize the input widened to float32 with their float32
statistics and round only the result, as flax's do.  torch.autocast is not
used: it picks per operator (a float32 layer norm and softmax, bf16 matrix
products) and so rounds at other points than flax.  In float32 each module
runs its own forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_NORMS = (nn.LayerNorm, nn.BatchNorm2d)


def run(m: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``m(x)`` computed in ``dtype`` (an ``nn.Sequential`` step by step);
    the result is in ``dtype``."""
    if isinstance(m, nn.Sequential):
        for sub in m:
            x = run(sub, x, dtype)
        return x
    x = x.to(dtype)
    if isinstance(m, _NORMS):
        return m(x.float()).to(dtype)
    if dtype == torch.float32 or not isinstance(m, (nn.Linear, nn.Conv2d)):
        return m(x)
    w = m.weight.to(dtype)
    if isinstance(m, nn.Linear):
        y, shape = F.linear(x, w), (-1,)
    else:
        y, shape = m._conv_forward(x, w, None), (-1, 1, 1)
    return y if m.bias is None else y + m.bias.to(dtype).view(shape)
