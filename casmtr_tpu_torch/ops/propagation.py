"""Propagation window geometry (reference: src/model/modules/
propagations.py:4-54): static [ww, 2] (dy, dx) offset tables."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_propagations(propagation: str, window_size: int, dilated: int = 1
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (window [ww, 2], full_window or None), int32 (dy, dx)."""
    assert window_size % 2 == 1
    half = window_size // 2
    full = None
    if propagation in ("window", "topk"):
        ys, xs = np.meshgrid(np.arange(-half, half + 1),
                             np.arange(-half, half + 1), indexing="ij")
        coords = np.stack([ys.ravel(), xs.ravel()], axis=-1)
    elif propagation == "dilated1":
        assert dilated > 1
        coords = [[0, 0]]
        for w in range(0, half + 1):
            for j in range(0, half + 1):
                if w + j == 0:
                    continue
                coords.append([dilated * j, dilated * w])
                if w != 0:
                    coords.append([dilated * j, -dilated * w])
                if j != 0:
                    coords.append([-dilated * j, dilated * w])
                if w != 0 and j != 0:
                    coords.append([-dilated * j, -dilated * w])
        coords = np.asarray(coords, np.int64)
        fw = []
        fh = half * dilated
        fw.append([0, 0])
        for w in range(0, fh + 1):
            for j in range(0, fh + 1):
                if w + j == 0:
                    continue
                fw.append([j, w])
                if w != 0:
                    fw.append([j, -w])
                if j != 0:
                    fw.append([-j, w])
                if w != 0 and j != 0:
                    fw.append([-j, -w])
        full = np.asarray(fw, np.int32)
    else:
        raise NotImplementedError(propagation)
    return np.asarray(coords, np.int32), full
