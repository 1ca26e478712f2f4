"""The PMT-refine model (counterpart of casmtr_tpu/models/casmtr_refine.py):
a frozen QuadTree trunk (``backbone``: ResNetFPN_8_4_2 in gray, and the 1/8
quadtree stack ``loftr_coarse``), a trainable side network ``ladder``
(``Ladder_4_2``, or the 1x1 projections ``proj4c``/``projf`` with
``no_lst``) over the images and the trunk's 1/4 and 1/2 maps, and new 4c
cascade and fine heads, the fine ones ``cas_``-prefixed so that a trunk
checkpoint's own fine heads do not load into them.  It runs the published
recipe ``indoor_casmtr_4c`` (trunk dims 128/196/256, ladder 64/128/256).

The trunk is frozen in two ways, as in the JAX package: it always runs in
eval mode (``train`` keeps it there: BatchNorm uses its running statistics
and the stack its eval precision, so on the card the bf16 instances of
kernels A and A′) under ``torch.no_grad``, and ``frozen_param_label`` keeps
its parameters out of the optimizer.  The rest follows CasMTR-4c
(models/casmtr.py) and its precision policy."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from casmtr_tpu_torch.config import LoftrConfig
from casmtr_tpu_torch.models.backbone.resnet_fpn import (Ladder_4_2,
                                                         ResNetFPN_8_4_2)
from casmtr_tpu_torch.models.cascade_transformer import \
    CascadeFeatureTransformer
from casmtr_tpu_torch.models.casmtr import (UpBlock, _grid, _tokens,
                                            detector_labels, stage_d2d)
from casmtr_tpu_torch.models.fine_preprocess import FinePreprocess
from casmtr_tpu_torch.models.loftr import check_fine_block, level_mask
from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
from casmtr_tpu_torch.ops import cascade_matching as cm
from casmtr_tpu_torch.ops import fine_matching as fm
from casmtr_tpu_torch.ops import matching
from casmtr_tpu_torch.ops.position_encoding import add_sine_pe_norm
from casmtr_tpu_torch.structs import (CascadeStage, CoarseStage, FineStage,
                                      MatchOutput)

FROZEN_PREFIXES = ("backbone", "loftr_coarse")
# the 1/8 sine PE is normalized to a ScanNet frame's grid, 480x640 / 8,
# whatever the train size
PE_SHAPE_8C = (60, 80)


def frozen_param_label(name: str) -> bool:
    """True if the parameter ``name`` (a ``named_parameters`` key) belongs
    to the frozen trunk."""
    return name.split(".", 1)[0] in FROZEN_PREFIXES


class CasMTRRefine(nn.Module):
    """Frozen quadtree trunk, ladder side network and CasMTR-4c heads."""

    def __init__(self, config: LoftrConfig):
        super().__init__()
        # one cascade stage at 1/4 whatever cascade_levels holds: the JAX
        # refine model never reads the field
        if config.coarse2.detector_mode not in (None, "ST", "gumbel"):
            raise NotImplementedError("detector modes: only ST and gumbel")
        self.config = config
        bb = config.backbone
        rd = tuple(bb.refine_dims)
        self.backbone = ResNetFPN_8_4_2(bb.initial_dim, tuple(bb.block_dims),
                                        is_rgb=False)
        self.loftr_coarse = LocalFeatureTransformer(config.coarse,
                                                     config.train_size // 8,
                                                     remat=config.remat)
        if config.training_stage >= 2:
            check_fine_block(config.fine)
            if bb.no_lst:
                self.proj4c = nn.Conv2d(bb.block_dims[1], rd[1], 1)
                self.projf = nn.Conv2d(bb.block_dims[0], rd[0], 1)
            else:
                self.ladder = Ladder_4_2(bb.block_dims, rd, config.is_rgb,
                                         config.bn_fix)
            self.up_block1 = UpBlock(config.coarse.d_model, rd[1])
            self.loftr_coarse_4c = CascadeFeatureTransformer(
                config.coarse2, remat=config.remat)
            self.cas_fine_preprocess = FinePreprocess(
                config.fine.d_model, config.coarse2.d_model, rd[0],
                config.fine_window_size, cat_c_feat=True)
            self.cas_loftr_fine = LocalFeatureTransformer(config.fine,
                                                          remat=config.remat)
        self.train()

    def train(self, mode: bool = True) -> "CasMTRRefine":
        """Set the mode of every module but the trunk, which stays in eval
        mode."""
        super().train(mode)
        self.backbone.eval()
        self.loftr_coarse.eval()
        return self

    def forward(self, batch: Dict[str, torch.Tensor],
                capacity_scale: int = 1) -> MatchOutput:
        """batch as CasMTR.forward's (image0/image1 [B, H, W, 3] of one
        shape, optional mask0/mask1 and scale0/scale1, and in training the
        4c ground truth gt_idx_4c / gt_mask_4c); ``capacity_scale``
        multiplies every fixed match capacity in eval."""
        cfg = self.config
        train = self.training
        ts = cfg.train_size
        img0 = batch["image0"].permute(0, 3, 1, 2)
        img1 = batch["image1"].permute(0, 3, 1, 2)
        H0, W0 = img0.shape[-2:]
        H1, W1 = img1.shape[-2:]
        mask0_full, mask1_full = batch.get("mask0"), batch.get("mask1")
        scale0, scale1 = batch.get("scale0"), batch.get("scale1")
        cat = torch.cat([img0, img1], dim=0)

        # ----- the frozen trunk -----
        with torch.no_grad():
            f8, f4, ff = self.backbone(cat)
            feat_8c0, feat_8c1 = f8.chunk(2)
            hw0_8c = tuple(feat_8c0.shape[-2:])
            hw1_8c = tuple(feat_8c1.shape[-2:])
            t8_0 = _tokens(add_sine_pe_norm(feat_8c0, PE_SHAPE_8C))
            t8_1 = _tokens(add_sine_pe_norm(feat_8c1, PE_SHAPE_8C))
            mask_8c0, m8_0 = level_mask(mask0_full, *hw0_8c)
            mask_8c1, m8_1 = level_mask(mask1_full, *hw1_8c)
            t8_0, t8_1 = self.loftr_coarse(t8_0, t8_1, hw0_8c, hw1_8c,
                                           mask_8c0, mask_8c1)
        mc8 = cfg.match_coarse
        ds = matching.dual_softmax(t8_0, t8_1, mc8.dsmax_temperature,
                                   mask_8c0, mask_8c1)
        matches_8c = matching.extract_coarse_matches(
            ds.conf_matrix, mc8.thr, mc8.border_rm, hw0_8c, hw1_8c,
            mc8.max_matches * capacity_scale, scale=H0 / hw0_8c[0],
            mask0=m8_0, mask1=m8_1, scale0=scale0, scale1=scale1)
        coarse = CoarseStage(ds.conf_matrix, ds.next_idx_c01, ds.next_idx_c10,
                             ds.next_conf_c01, ds.next_conf_c10, matches_8c,
                             hw0_8c, hw1_8c)
        if cfg.training_stage < 2:
            return MatchOutput(coarse, {}, None, matches_8c, (H0, W0),
                               (H1, W1))

        # ----- the ladder and the 1/4 cascade level -----
        if cfg.backbone.no_lst:
            f4r, ffr = self.proj4c(f4), self.projf(ff)
        else:
            f4r, ffr = self.ladder(cat, [f4, ff])
        feat_f0, feat_f1 = ffr.chunk(2)
        hw0, hw1 = (H0 // 4, W0 // 4), (H1 // 4, W1 // 4)
        f0, f1 = self.up_block1(f4r, torch.cat([_grid(t8_0, hw0_8c),
                                                _grid(t8_1, hw1_8c)])
                                ).chunk(2)
        t0 = _tokens(add_sine_pe_norm(f0, (ts // 4, ts // 4)))
        t1 = _tokens(add_sine_pe_norm(f1, (ts // 4, ts // 4)))
        mask_0, m_0 = level_mask(mask0_full, *hw0)
        mask_1, m_1 = level_mask(mask1_full, *hw1)
        t0, t1, idx01, idx10, corners01, corners10, heat = \
            self.loftr_coarse_4c(t0, t1, ds.next_idx_c01, ds.next_idx_c10,
                                 hw0, hw1, hw0_8c, hw1_8c, ds.next_idx_c01,
                                 ds.next_idx_c10, ds.conf_matrix)
        mc, scfg = cfg.match_cascade, cfg.coarse2
        ws = cm.window_softmax_matching(
            t0, t1, idx01, idx10, mc.dsmax_temperature[0], mask_0, mask_1,
            corners0=corners01, corners1=corners10, hw0=hw0, hw1=hw1,
            prop_window=scfg.window_size)
        if train:
            mask = cm.cascade_match_mask_train(
                ws, mc.thr[0], idx01.shape[-1], hw0, hw1, mc.border_rm[0],
                mc.double_check[0], m_0, m_1)
            m_cap = min(mc.train_pad_num_gt_min[0], mc.max_matches[0])
        else:
            # the JAX package's refine model passes the filters but neither
            # the rt/rd gates nor image0 (so 'sift' raises there)
            pc = scfg.post_config
            s_d2d, d2d_w = stage_d2d(scfg, t0, hw0)
            mask = cm.cascade_match_mask_test(
                ws, hw0, hw1, mc.test_thr[0], mc.border_rm[0],
                pre_confs=[ds.next_conf_c01], pre_hws=[hw0_8c],
                pre_thrs=list(mc.pre_thr[0]), post_method=pc.method,
                post_window=pc.window_size, post_topk=pc.topk,
                post_temperature=pc.temperature, post_stride=pc.stride,
                double_check=mc.double_check[0], mask0_2d=m_0, mask1_2d=m_1,
                s_d2d=s_d2d, d2d_w=d2d_w)
            m_cap = mc.max_matches[0] * capacity_scale
        gt_idx = batch.get("gt_idx_4c") if train else None
        gt_mask = batch.get("gt_mask_4c") if train else None
        matches, extras = cm.extract_cascade_matches(
            ws, mask, hw0, hw1, m_cap, scale=H0 / hw0[0], scale0=scale0,
            scale1=scale1, priority=batch.get("priority_4c"),
            idx_c01=idx01 if train else None, gt_idx_c01=gt_idx,
            gt_mask_c01=gt_mask)
        det = detector_labels(scfg, heat, ws, mask, idx01, gt_idx, gt_mask,
                              m_cap, hw0, batch.get("sample_uniform_4c"))
        cascades = {"4c": CascadeStage(
            ws.conf01, idx01, idx10, ws.next_idx_c01, ws.next_idx_c10,
            ws.next_conf_c01, ws.next_conf_c10, matches, hw0, hw1,
            extras.get("window_gt_label"), extras.get("window_conf"), *det)}

        # ----- the fine sub-pixel stage on the ladder's 1/2 map -----
        Wf = cfg.fine_window_size
        ff0, ff1 = self.cas_fine_preprocess(
            feat_f0.permute(0, 2, 3, 1), feat_f1.permute(0, 2, 3, 1), t0, t1,
            matches, hw0, hw1)
        ff0, ff1 = self.cas_loftr_fine(ff0, ff1, (Wf, Wf), (Wf, Wf))
        fr = fm.fine_match(ff0, ff1)
        s1 = scale1[matches.b_ids] if scale1 is not None else None
        mk0, mk1 = fm.fine_keypoints(matches, fr.coords_norm, Wf,
                                     scale_f=H0 / feat_f0.shape[-2],
                                     scale1=s1)
        return MatchOutput(coarse, cascades, FineStage(fr.expec_f, mk0, mk1),
                           matches._replace(mkpts0=mk0, mkpts1=mk1),
                           (H0, W0), (H1, W1))
