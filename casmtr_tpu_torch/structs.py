"""Typed forward outputs of the PyTorch port (counterpart of casmtr_tpu/structs.py).

Shapes are fixed: the variable-length match lists of the reference become
fixed-capacity buffers with a ``valid`` mask, exactly as in the JAX package,
so the two packages' match sets compare slot for slot.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch


class Matches(NamedTuple):
    """A fixed-capacity set of matches (capacity M = config max_matches).
    Invalid slots have valid=False and are ignored by all consumers."""
    b_ids: torch.Tensor       # [M] int64 batch index
    i_ids: torch.Tensor       # [M] int64 flat position in image0 grid
    j_ids: torch.Tensor       # [M] int64 flat position in image1 grid
    mconf: torch.Tensor       # [M] f32 confidence
    valid: torch.Tensor       # [M] bool
    mkpts0: torch.Tensor      # [M, 2] f32 (x, y) in original image0 pixels
    mkpts1: torch.Tensor      # [M, 2] f32 (x, y) in original image1 pixels


class CoarseStage(NamedTuple):
    """Output of the 1/8 dual-softmax stage."""
    conf_matrix: torch.Tensor     # [B, L0, L1]
    next_idx_c01: torch.Tensor    # [B, L0]
    next_idx_c10: torch.Tensor    # [B, L1]
    next_conf_c01: torch.Tensor   # [B, L0]
    next_conf_c10: torch.Tensor   # [B, L1]
    matches: Matches
    hw0: Tuple[int, int]
    hw1: Tuple[int, int]


class CascadeStage(NamedTuple):
    """Output of a cascade matching level; the window labels and the
    detector branch's labels exist only in training (None in eval, and the
    detector's also without ``detector_mode``)."""
    conf_matrix: torch.Tensor     # [B, L0, Kw] window softmax confidences
    idx_c01: torch.Tensor         # [B, L0, Kw] candidate indices
    idx_c10: torch.Tensor         # [B, L1, Kw]
    next_idx_c01: torch.Tensor    # [B, L0]
    next_idx_c10: torch.Tensor    # [B, L1]
    next_conf_c01: torch.Tensor   # [B, L0]
    next_conf_c10: torch.Tensor   # [B, L1]
    matches: Matches
    hw0: Tuple[int, int]
    hw1: Tuple[int, int]
    window_gt_label: Optional[torch.Tensor] = None  # [M, Kw] bool one-hot
    window_conf: Optional[torch.Tensor] = None      # [M, Kw] f32
    detector_gt_label: Optional[torch.Tensor] = None  # [M, Kw] bool one-hot
    detector_conf: Optional[torch.Tensor] = None      # [M, Kw] f32
    detector_valid: Optional[torch.Tensor] = None     # [M] bool


class FineStage(NamedTuple):
    """Sub-pixel refinement output."""
    expec_f: torch.Tensor     # [M, 3] normalized (x, y) offset + std
    mkpts0_f: torch.Tensor    # [M, 2]
    mkpts1_f: torch.Tensor    # [M, 2]


class MatchOutput(NamedTuple):
    """Full forward output of CasMTR."""
    coarse: CoarseStage
    cascades: Dict[str, CascadeStage]
    fine: Optional[FineStage]
    final_matches: Matches       # the match set fed to pose estimation
    hw0_i: Tuple[int, int]
    hw1_i: Tuple[int, int]
