"""Fine-level window preprocessing (counterpart of
casmtr_tpu/models/fine_preprocess.py)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from casmtr_tpu_torch.ops.fine_matching import extract_windows
from casmtr_tpu_torch.structs import Matches


class FinePreprocess(nn.Module):
    """Gathers W x W windows at the fine level around each match and, with
    ``cat_c_feat``, fuses down-projected coarse features into them."""

    def __init__(self, d_model_f: int, d_model_c: int, d_feat_f: int,
                 window_size: int, cat_c_feat: bool = True):
        super().__init__()
        self.window_size = window_size
        self.cat_c_feat = cat_c_feat
        if cat_c_feat:
            self.down_proj = nn.Linear(d_model_c, d_model_f)
            self.merge_feat = nn.Linear(d_feat_f + d_model_f, d_model_f)

    def forward(self, feat_f0, feat_f1, feat_c0, feat_c1, matches: Matches,
                hw0_c: Tuple[int, int], hw1_c: Tuple[int, int]):
        """feat_f*: [B, Hf, Wf, Cf] fine maps; feat_c*: [B, Lc, Cc] coarse
        tokens.  Returns ([M, W*W, Cf'], [M, W*W, Cf'])."""
        W = self.window_size
        stride = feat_f0.shape[1] // hw0_c[0]
        f0 = extract_windows(feat_f0, matches.b_ids, matches.i_ids, hw0_c,
                             stride, W)
        f1 = extract_windows(feat_f1, matches.b_ids, matches.j_ids, hw1_c,
                             stride, W)
        if not self.cat_c_feat:
            return f0, f1
        c0 = feat_c0[matches.b_ids, matches.i_ids]           # [M, Cc]
        c1 = feat_c1[matches.b_ids, matches.j_ids]
        cat = self.down_proj(torch.cat([c0, c1], dim=0))     # [2M, Cf']
        both = torch.cat([f0, f1], dim=0)                    # [2M, WW, Cf]
        cat = cat[:, None].expand(-1, both.shape[1], -1)
        merged = self.merge_feat(torch.cat([both, cat], dim=-1))
        return merged.chunk(2, dim=0)
