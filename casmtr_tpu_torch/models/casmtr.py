"""CasMTR-4c forward in eval and train mode (counterpart of
casmtr_tpu/models/casmtr.py for ``cascade_levels=(4,)``): backbone pyramid
-> 1/8 quadtree transformer + dual-softmax -> UpBlock fusion -> 1/4 cascade
transformer + window matching -> fine sub-pixel refinement.  Computes in
float32.  ``module.training`` selects the mode: in training BatchNorm uses
batch statistics and the 1/4 matches are the ground-truth-filtered ones
that the loss supervises."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from casmtr_tpu_torch.config import LoftrConfig
from casmtr_tpu_torch.models.backbone import build_backbone
from casmtr_tpu_torch.models.backbone.resnet_fpn import bn, conv3x3
from casmtr_tpu_torch.models.cascade_transformer import \
    CascadeFeatureTransformer
from casmtr_tpu_torch.models.fine_preprocess import FinePreprocess
from casmtr_tpu_torch.models.loftr import level_mask
from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
from casmtr_tpu_torch.ops import cascade_matching as cm
from casmtr_tpu_torch.ops import fine_matching as fm
from casmtr_tpu_torch.ops import matching
from casmtr_tpu_torch.ops.image_ops import resize_bilinear_align_corners
from casmtr_tpu_torch.ops.position_encoding import add_sine_pe_norm
from casmtr_tpu_torch.structs import (CascadeStage, CoarseStage, FineStage,
                                      MatchOutput)


class UpBlock(nn.Module):
    """2x upsample-and-fuse of the coarser level into the finer one."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.inner = nn.Sequential(nn.Conv2d(dim_in, dim_out, 1, bias=False),
                                   bn(dim_out))
        self.up = nn.Sequential(conv3x3(dim_out, dim_out), bn(dim_out),
                                nn.LeakyReLU(0.01))

    def forward(self, feat_2x: torch.Tensor, feat_c: torch.Tensor):
        """feat_2x: [B, dim_out, H, W]; feat_c: [B, dim_in, H/2, W/2]."""
        up = resize_bilinear_align_corners(feat_c, *feat_2x.shape[-2:])
        return self.up(feat_2x + self.inner(up))


def _check_ported(cfg: LoftrConfig) -> None:
    """Raise NotImplementedError for config branches the 4c path does not
    take (the submodules check their own)."""
    if tuple(cfg.cascade_levels) != (4,):
        raise NotImplementedError(
            f"cascade_levels {tuple(cfg.cascade_levels)}: only CasMTR-4c is "
            "ported (ROADMAP queue A: the 2c recipe)")
    pc = cfg.coarse2.post_config
    if pc.rt is not None or pc.rd is not None:
        raise NotImplementedError(
            "the rt/rd test gates are not ported yet (ROADMAP queue A: "
            "the 2c recipe)")
    if cfg.fine.block_type != "loftr":
        raise NotImplementedError(
            f"fine block {cfg.fine.block_type!r} is not ported yet")
    if cfg.coarse2.detector_mode is not None:
        raise NotImplementedError(
            "the keypoint detector branch is not ported yet (ROADMAP queue "
            "A: the indoor recipe)")


class CasMTR(nn.Module):
    """Cascade matching transformer, CasMTR-4c."""

    def __init__(self, config: LoftrConfig):
        super().__init__()
        _check_ported(config)
        self.config = config
        bd = tuple(config.backbone.block_dims)
        self.backbone = build_backbone(config)
        self.loftr_coarse_8c = LocalFeatureTransformer(config.coarse)
        if config.training_stage >= 2:
            self.up_block1 = UpBlock(config.coarse.d_model, bd[1])
            self.loftr_coarse_4c = CascadeFeatureTransformer(config.coarse2)
            self.fine_preprocess = FinePreprocess(
                config.fine.d_model, config.coarse2.d_model, bd[0],
                config.fine_window_size,
                cat_c_feat=config.fine_concat_coarse_feat)
            self.loftr_fine = LocalFeatureTransformer(config.fine)

    def forward(self, batch: Dict[str, torch.Tensor],
                capacity_scale: int = 1) -> MatchOutput:
        """batch: image0/image1 [B, H, W, 3] RGB in [0, 1]; optional
        mask0/mask1 [B, H, W] (True = valid) and scale0/scale1 [B, 2]
        (original pixels per model pixel).  In training the batch also holds
        the 1/4 ground truth gt_idx_4c / gt_mask_4c [B, L0]
        (train.supervision.compute_supervision) and optionally a selection
        priority_4c [B, L0].  ``capacity_scale`` multiplies every fixed match
        capacity in eval (a batch of B pairs shares one selection, so a
        B-pair forward passes B)."""
        cfg = self.config
        train = self.training
        ts = cfg.train_size
        img0 = batch["image0"].permute(0, 3, 1, 2)
        img1 = batch["image1"].permute(0, 3, 1, 2)
        B, _, H0, W0 = img0.shape
        H1, W1 = img1.shape[-2:]
        mask0_full, mask1_full = batch.get("mask0"), batch.get("mask1")
        scale0, scale1 = batch.get("scale0"), batch.get("scale1")

        if (H0, W0) == (H1, W1):
            f8, f4, ff = self.backbone(torch.cat([img0, img1], dim=0))
            feat_8c0, feat_8c1 = f8.chunk(2)
            feat_4c0, feat_4c1 = f4.chunk(2)
            feat_f0, feat_f1 = ff.chunk(2)
        else:
            feat_8c0, feat_4c0, feat_f0 = self.backbone(img0)
            feat_8c1, feat_4c1, feat_f1 = self.backbone(img1)
        hw0_8c, hw1_8c = tuple(feat_8c0.shape[-2:]), tuple(feat_8c1.shape[-2:])
        hw0_4c, hw1_4c = tuple(feat_4c0.shape[-2:]), tuple(feat_4c1.shape[-2:])
        hw0_f = tuple(feat_f0.shape[-2:])

        # ----- 1/8 coarse stage -----
        def tokens(x):  # [B, C, h, w] -> [B, h*w, C]
            return x.flatten(2).transpose(1, 2)

        t8_0 = tokens(add_sine_pe_norm(feat_8c0, (ts // 8, ts // 8)))
        t8_1 = tokens(add_sine_pe_norm(feat_8c1, (ts // 8, ts // 8)))
        mask_8c0, m8_0 = level_mask(mask0_full, *hw0_8c)
        mask_8c1, m8_1 = level_mask(mask1_full, *hw1_8c)
        t8_0, t8_1 = self.loftr_coarse_8c(t8_0, t8_1, hw0_8c, hw1_8c,
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

        # ----- 1/4 cascade stage -----
        x8_0 = t8_0.transpose(1, 2).reshape(B, -1, *hw0_8c)
        x8_1 = t8_1.transpose(1, 2).reshape(B, -1, *hw1_8c)
        if hw0_4c == hw1_4c:
            fused = self.up_block1(torch.cat([feat_4c0, feat_4c1], dim=0),
                                   torch.cat([x8_0, x8_1], dim=0))
            feat_4c0, feat_4c1 = fused.chunk(2)
        else:
            feat_4c0 = self.up_block1(feat_4c0, x8_0)
            feat_4c1 = self.up_block1(feat_4c1, x8_1)
        t4_0 = tokens(add_sine_pe_norm(feat_4c0, (ts // 4, ts // 4)))
        t4_1 = tokens(add_sine_pe_norm(feat_4c1, (ts // 4, ts // 4)))
        mask_4c0, m4_0 = level_mask(mask0_full, *hw0_4c)
        mask_4c1, m4_1 = level_mask(mask1_full, *hw1_4c)
        (t4_0, t4_1, idx_4c01, idx_4c10, corners01,
         corners10) = self.loftr_coarse_4c(t4_0, t4_1, ds.next_idx_c01,
                                           ds.next_idx_c10, hw0_4c, hw1_4c)

        mc = cfg.match_cascade
        pc = cfg.coarse2.post_config
        ws4 = cm.window_softmax_matching(
            t4_0, t4_1, idx_4c01, idx_4c10, mc.dsmax_temperature[0],
            mask_4c0, mask_4c1, corners0=corners01, corners1=corners10,
            hw0=hw0_4c, hw1=hw1_4c, prop_window=cfg.coarse2.window_size)
        if train:
            mask4 = cm.cascade_match_mask_train(
                ws4, mc.thr[0], idx_4c01.shape[-1], hw0_4c, hw1_4c,
                mc.border_rm[0], mc.double_check[0], m4_0, m4_1)
            m_cap4 = min(mc.train_pad_num_gt_min[0], mc.max_matches[0])
        else:
            mask4 = cm.cascade_match_mask_test(
                ws4, hw0_4c, hw1_4c, mc.test_thr[0], mc.border_rm[0],
                pre_confs=[ds.next_conf_c01], pre_hws=[hw0_8c],
                pre_thrs=list(mc.pre_thr[0]), post_method=pc.method,
                post_window=pc.window_size, double_check=mc.double_check[0],
                mask0_2d=m4_0, mask1_2d=m4_1)
            m_cap4 = mc.max_matches[0] * capacity_scale
        matches_4c, extras4 = cm.extract_cascade_matches(
            ws4, mask4, hw0_4c, hw1_4c, m_cap4, scale=H0 / hw0_4c[0],
            scale0=scale0, scale1=scale1,
            priority=batch.get("priority_4c"),
            idx_c01=idx_4c01 if train else None,
            gt_idx_c01=batch.get("gt_idx_4c") if train else None,
            gt_mask_c01=batch.get("gt_mask_4c") if train else None)
        cascades = {"4c": CascadeStage(
            ws4.conf01, idx_4c01, idx_4c10, ws4.next_idx_c01,
            ws4.next_idx_c10, ws4.next_conf_c01, ws4.next_conf_c10,
            matches_4c, hw0_4c, hw1_4c,
            window_gt_label=extras4.get("window_gt_label"),
            window_conf=extras4.get("window_conf"))}

        # ----- fine sub-pixel stage -----
        Wf = cfg.fine_window_size
        ff0, ff1 = self.fine_preprocess(
            feat_f0.permute(0, 2, 3, 1), feat_f1.permute(0, 2, 3, 1),
            t4_0, t4_1, matches_4c, hw0_4c, hw1_4c)
        ff0, ff1 = self.loftr_fine(ff0, ff1, (Wf, Wf), (Wf, Wf))
        fr = fm.fine_match(ff0, ff1)
        s1 = scale1[matches_4c.b_ids] if scale1 is not None else None
        mk0, mk1 = fm.fine_keypoints(matches_4c, fr.coords_norm, Wf,
                                     scale_f=H0 / hw0_f[0], scale1=s1)
        return MatchOutput(coarse, cascades, FineStage(fr.expec_f, mk0, mk1),
                           matches_4c._replace(mkpts0=mk0, mkpts1=mk1),
                           (H0, W0), (H1, W1))
