"""The plain QuadtreeLoFTR assembly and the level padding masks
(counterpart of casmtr_tpu/models/loftr.py): backbone -> sine PE -> coarse
transformer (1/8, or 1/16 on the ResNetFPN_16_4 and TwinsFPN_16_8_4_2
backbones) -> dual-softmax matching -> fine window refinement, in eval and
train mode (``module.training``), in the precision policy of
models/casmtr.py."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from casmtr_tpu_torch.models.backbone import build_backbone
from casmtr_tpu_torch.models.backbone.resnet_fpn import ResNetFPN_16_4
from casmtr_tpu_torch.models.fine_preprocess import FinePreprocess
from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
from casmtr_tpu_torch.ops import fine_matching as fm
from casmtr_tpu_torch.ops import matching
from casmtr_tpu_torch.ops.image_ops import resize_nearest
from casmtr_tpu_torch.ops.position_encoding import add_sine_pe_norm
from casmtr_tpu_torch.structs import CoarseStage, FineStage, MatchOutput


def level_mask(mask_full: Optional[torch.Tensor], h: int, w: int):
    """Nearest-downsample a full-resolution padding mask [B, H, W] to a level
    grid.  Returns ([B, h*w] float, [B, h, w] float), or (None, None)."""
    if mask_full is None:
        return None, None
    m = resize_nearest(mask_full.float(), h, w)
    return m.reshape(m.shape[0], -1), m


def check_fine_block(fine_cfg) -> None:
    """Refuse a fine stack that the JAX package cannot build.  Its
    ``FineConfig`` has no ``topks``, and the quadtree branch of its
    ``LocalFeatureTransformer`` reads ``cfg.topks``: a fine ``block_type``
    'quadtree' fails there with AttributeError when the model is
    initialized, so there is nothing to port (NotImplementedError).  Any
    value but 'loftr' and 'quadtree' raises ValueError, as the JAX stack
    does."""
    block = fine_cfg.block_type
    if block == "quadtree":
        raise NotImplementedError(
            "fine block_type 'quadtree': the JAX package cannot build it "
            "(its FineConfig has no topks, which the quadtree branch of "
            "LocalFeatureTransformer reads: AttributeError at init), so "
            "there is nothing to port")
    if block != "loftr":
        raise ValueError(block)


class QuadtreeLoFTR(nn.Module):
    """LoFTR with quadtree attention at the backbone's coarsest map
    (``loftr_coarse``; 1/8, or 1/16) and linear attention in the fine
    windows on its finest map; no cascade.  The sine PE is normalized to
    ``train_size // 8`` and the coarse stack sized by it at either level,
    as in the JAX package."""

    def __init__(self, config):
        super().__init__()
        check_fine_block(config.fine)
        self.config = config
        self.backbone = build_backbone(config)
        # the finest map: 1/4 (block_dims[1]) on ResNetFPN_16_4, else 1/2
        bd = config.backbone.block_dims
        fine_dim = (bd[1] if isinstance(self.backbone, ResNetFPN_16_4)
                    else bd[0])
        self.loftr_coarse = LocalFeatureTransformer(config.coarse,
                                                     config.train_size // 8,
                                                     remat=config.remat)
        self.fine_preprocess = FinePreprocess(
            config.fine.d_model, config.coarse.d_model,
            fine_dim, config.fine_window_size,
            cat_c_feat=config.fine_concat_coarse_feat)
        self.loftr_fine = LocalFeatureTransformer(config.fine,
                                                  remat=config.remat)

    def forward(self, batch: Dict[str, torch.Tensor],
                capacity_scale: int = 1) -> MatchOutput:
        """batch as CasMTR.forward's (image0/image1 [B, H, W, 3], optional
        mask0/mask1 and scale0/scale1); ``capacity_scale`` multiplies the
        match capacity in eval (a batch of B pairs shares one selection)."""
        cfg = self.config
        ts = cfg.train_size
        img0 = batch["image0"].permute(0, 3, 1, 2)
        img1 = batch["image1"].permute(0, 3, 1, 2)
        B, _, H0, W0 = img0.shape
        H1, W1 = img1.shape[-2:]
        scale0, scale1 = batch.get("scale0"), batch.get("scale1")

        # the coarsest and the finest map of the pyramid
        if (H0, W0) == (H1, W1):   # both images in one BatchNorm batch
            feats = self.backbone(torch.cat([img0, img1], dim=0))
            feat_c0, feat_c1 = feats[0].chunk(2)
            feat_f0, feat_f1 = feats[-1].chunk(2)
        else:
            f0s, f1s = self.backbone(img0), self.backbone(img1)
            feat_c0, feat_f0 = f0s[0], f0s[-1]
            feat_c1, feat_f1 = f1s[0], f1s[-1]
        hc0, hc1 = tuple(feat_c0.shape[-2:]), tuple(feat_c1.shape[-2:])

        t0, t1 = (add_sine_pe_norm(f, (ts // 8, ts // 8)).flatten(2)
                  .transpose(1, 2) for f in (feat_c0, feat_c1))
        mask_c0, m0 = level_mask(batch.get("mask0"), *hc0)
        mask_c1, m1 = level_mask(batch.get("mask1"), *hc1)
        t0, t1 = self.loftr_coarse(t0, t1, hc0, hc1, mask_c0, mask_c1)
        mc = cfg.match_coarse
        ds = matching.dual_softmax(t0, t1, mc.dsmax_temperature, mask_c0,
                                   mask_c1)
        matches = matching.extract_coarse_matches(
            ds.conf_matrix, mc.thr, mc.border_rm, hc0, hc1,
            mc.max_matches * capacity_scale,
            scale=H0 / hc0[0], mask0=m0, mask1=m1, scale0=scale0,
            scale1=scale1)
        coarse = CoarseStage(ds.conf_matrix, ds.next_idx_c01, ds.next_idx_c10,
                             ds.next_conf_c01, ds.next_conf_c10, matches,
                             hc0, hc1)

        Wf = cfg.fine_window_size
        ff0, ff1 = self.fine_preprocess(
            feat_f0.permute(0, 2, 3, 1), feat_f1.permute(0, 2, 3, 1), t0, t1,
            matches, hc0, hc1)
        ff0, ff1 = self.loftr_fine(ff0, ff1, (Wf, Wf), (Wf, Wf))
        fr = fm.fine_match(ff0, ff1)
        s1 = scale1[matches.b_ids] if scale1 is not None else None
        mk0, mk1 = fm.fine_keypoints(matches, fr.coords_norm, Wf,
                                     scale_f=H0 / feat_f0.shape[-2],
                                     scale1=s1)
        return MatchOutput(coarse, {}, FineStage(fr.expec_f, mk0, mk1),
                           matches._replace(mkpts0=mk0, mkpts1=mk1),
                           (H0, W0), (H1, W1))
