"""CasMTR forward in eval and train mode (counterpart of
casmtr_tpu/models/casmtr.py): CasMTR-4c (``cascade_levels`` (4,)), CasMTR-2c
((4, 2)), the indoor ``indoor_casmtr_4c_runnable``, and any other tuple as
the JAX package runs it (the empty one and longer ones included):
backbone pyramid -> 1/8 quadtree transformer + dual-softmax -> per cascade
stage (1/4, then 1/2) UpBlock fusion, cascade transformer and window
matching -> fine sub-pixel refinement.
The stages come from the tuple's length alone, as in the JAX package: the
first stage runs at 1/4 (``up_block1``, ``loftr_coarse_4c``, the cascade
key ``4c``) and the second, when the tuple has more than one value, at 1/2
(``up_block2``, ``loftr_coarse_2c``, ``2c``), whatever the values; each
stage reads its ground truth under its own key (gt_idx_4c, gt_idx_2c),
while the training step supplies ``gt_idx_{value}c`` for each value, so a
stage whose key is missing trains without ground truth and adds no loss
term.  With no value the first stage still runs and the fine stage does
not.
``training_stage`` selects how much of it is built and runs, as in the JAX
package (``run_stages``, ``runs_fine``): stage 1 the 1/8 stage alone,
stage 2 adds the 1/4 stage (and with one value the fine stage), stage 3
the whole model.
``module.training`` selects the mode: in training BatchNorm uses batch
statistics and each cascade stage's matches are the ground-truth-filtered
ones that the loss supervises; a stage with a ``detector_mode`` also
selects its keypoint-detector labels then.  In eval each stage's matches
pass its ``post_config``: a test-time filter (ops/nms.py; ``d2d`` on the
stage's tokens, ``sift`` on the batch's image0 and mask0) and the rt/rd
gates, whose second bests the 1/8 dual softmax and the window softmaxes
track only when a gate asks for them.

Precision follows the JAX package's policy, read from the tensors' device
and the mode: on the card the backbone computes in bfloat16 in eval and in
training (``backbone_dtype``), the coarse, cascade and fine stacks in
bfloat16 in eval and float32 in training (``transformer_dtype``), and
kernels A, A′ and C (and in training A-bwd and C-bwd) take bf16 q/k/v in
both modes (``table_dtype``); parameters and normalization statistics stay
float32, every stack returns float32, and the UpBlocks, matching heads, fine
preprocessing and kernel B compute in float32.
``CASMTR_BACKBONE_BF16=0/1`` and ``CASMTR_TRANSFORMER_BF16=0/1`` force the
backbone's and the stacks' dtype; the stacks' variable at 0 also keeps the
kernels' q/k/v float32, so both at 0 make the card's graph all float32.  On
the CPU everything is float32 unless a variable forces bf16 (the kernels'
q/k/v stay float32 there, as in the JAX package's CPU graph)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from casmtr_tpu_torch.config import LoftrConfig
from casmtr_tpu_torch.models.backbone import build_backbone
from casmtr_tpu_torch.models.backbone.resnet_fpn import (ResNetFPN_16_4, bn,
                                                         conv3x3)
from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_16_8_4_2
from casmtr_tpu_torch.models.cascade_transformer import \
    CascadeFeatureTransformer
from casmtr_tpu_torch.models.fine_preprocess import FinePreprocess
from casmtr_tpu_torch.models.loftr import check_fine_block, level_mask
from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
from casmtr_tpu_torch.ops import cascade_matching as cm
from casmtr_tpu_torch.ops import fine_matching as fm
from casmtr_tpu_torch.ops import matching, nms
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


# the cascade stages by position: (the stage's grid as a fraction of the
# image, its name: the cascade key and the suffix of its modules and of its
# ground-truth, priority and detector keys)
STAGES = ((4, "4c"), (2, "2c"))


def _check_ported(cfg: LoftrConfig) -> None:
    """Raise for config branches that the JAX package cannot run (the
    submodules check their own).  Every ``cascade_levels`` tuple runs, as
    in the JAX package: values past the second only add ground truth that
    no stage reads."""
    if any(s.detector_mode not in (None, "ST", "gumbel")
           for s in stage_configs(cfg)):
        raise NotImplementedError("detector modes: only ST and gumbel")


def stage_configs(cfg: LoftrConfig) -> tuple:
    """The cascade stages' configurations (``coarse2``, then ``coarse3``
    for a tuple of two or more values), built or not: their post configs
    decide which softmaxes track second bests, as in the JAX package."""
    return (cfg.coarse2, cfg.coarse3)[:1 + (len(cfg.cascade_levels) > 1)]


def stage_d2d(stage_cfg, tokens: torch.Tensor, hw):
    """A cascade stage's d2d saliency and its grid's width, for the
    ``d2d`` test-time filter (None, None for any other method): the
    saliency of the stage's sqrt(C)-scaled tokens [B, h*w, C]."""
    if stage_cfg.post_config.method != "d2d":
        return None, None
    return (nms.d2d_saliency(tokens.float() / tokens.shape[-1] ** 0.5, hw),
            hw[1] // 4)


def run_stages(cfg: LoftrConfig) -> int:
    """How many cascade stages ``cfg.training_stage`` builds and runs, as in
    the JAX package, which counts them from the length of
    ``cascade_levels``: none at stage 1 (the 1/8 stage alone), the 1/4
    stage from stage 2 (with any tuple, the empty one included), and the
    1/2 stage only at stage 3 and only for two or more values."""
    if cfg.training_stage < 2:
        return 0
    return 2 if cfg.training_stage >= 3 and len(cfg.cascade_levels) > 1 \
        else 1


def runs_fine(cfg: LoftrConfig) -> bool:
    """Whether the fine stage is built and run, as in the JAX package: with
    one value from stage 2, with more only at stage 3 (a two-stage model at
    stage 2 ends at its 1/4 matches), with none never."""
    n = len(cfg.cascade_levels)
    return n > 0 and cfg.training_stage >= (2 if n == 1 else 3)


def detector_labels(stage_cfg, heat, ws, mask, idx_c01, gt_idx, gt_mask,
                    m_cap: int, hw0, uniform=None):
    """A cascade stage's keypoint-detector labels in training (None x 3
    without ``detector_mode`` or ground truth): the heatmap of the
    learnable head, else each query's largest masked window score before
    its softmax, picks one position per grid cell (``detect_keypoints``;
    ``uniform`` is the gumbel mode's draw, ``sample_uniform_{name}`` of
    the batch), and ``select_detector_labels`` takes the labels."""
    if stage_cfg.detector_mode is None or gt_idx is None:
        return None, None, None
    if heat is None:
        heat = ws.max_sim_c01.reshape(ws.max_sim_c01.shape[0], *hw0)
    det = cm.detect_keypoints(heat, ws.conf01, stage_cfg.detector_mode,
                              stage_cfg.grid_size or 4, uniform)
    return cm.select_detector_labels(det, mask, idx_c01, gt_idx, gt_mask,
                                     m_cap)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, h*w, C]."""
    return x.flatten(2).transpose(1, 2)


def _grid(t: torch.Tensor, hw) -> torch.Tensor:
    """[B, h*w, C] -> [B, C, h, w]."""
    return t.transpose(1, 2).reshape(t.shape[0], -1, *hw)


class CasMTR(nn.Module):
    """Cascade matching transformer: cascade_levels (4,) is CasMTR-4c,
    (4, 2) CasMTR-2c; any other tuple runs as the JAX package runs it (the
    module docstring)."""

    def __init__(self, config: LoftrConfig):
        super().__init__()
        _check_ported(config)
        self.config = config
        bd = tuple(config.backbone.block_dims)
        self.backbone = build_backbone(config)
        if isinstance(self.backbone, (ResNetFPN_16_4, TwinsFPN_16_8_4_2)):
            raise ValueError(
                f"{type(self.backbone).__name__} under a cascade: CasMTR "
                "takes the [1/8, 1/4, 1/2] pyramid, and the 1/16 backbones "
                "serve the plain QuadtreeLoFTR only (cascade false)")
        self.loftr_coarse_8c = LocalFeatureTransformer(
            config.coarse, config.train_size // 8, remat=config.remat)
        n = run_stages(config)
        if n >= 1:
            self.up_block1 = UpBlock(config.coarse.d_model, bd[1])
            self.loftr_coarse_4c = CascadeFeatureTransformer(
                config.coarse2, remat=config.remat)
        if n >= 2:
            self.up_block2 = UpBlock(config.coarse2.d_model, bd[0])
            self.loftr_coarse_2c = CascadeFeatureTransformer(
                config.coarse3, remat=config.remat)
        if runs_fine(config):
            check_fine_block(config.fine)
            # after two stages the fine stage refines the 1/2 tokens
            # themselves; after one the 1/2 backbone map with the 1/4 tokens
            # as context
            two = n > 1
            d_c = config.coarse3.d_model if two else config.coarse2.d_model
            self.fine_preprocess = FinePreprocess(
                config.fine.d_model, d_c, d_c if two else bd[0],
                config.fine_window_size,
                cat_c_feat=config.fine_concat_coarse_feat)
            self.loftr_fine = LocalFeatureTransformer(config.fine,
                                                      remat=config.remat)

    def forward(self, batch: Dict[str, torch.Tensor],
                capacity_scale: int = 1) -> MatchOutput:
        """batch: image0/image1 [B, H, W, 3] RGB in [0, 1]; optional
        mask0/mask1 [B, H, W] (True = valid) and scale0/scale1 [B, 2]
        (original pixels per model pixel).  In training the batch also holds
        the ground truth gt_idx_{value}c / gt_mask_{value}c [B, L] of each
        value of ``cascade_levels`` (train.supervision.compute_supervision),
        of which each stage reads its own name's, gt_idx_{4c,2c}, optionally
        a selection priority_{4c,2c} [B, L0], and for a gumbel detector the
        draw sample_uniform_{4c,2c} (train.train_step.detector_uniforms).
        ``capacity_scale`` multiplies every fixed match capacity in eval (a
        batch of B pairs shares one selection, so a B-pair forward passes
        B)."""
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
        hw0_f = tuple(feat_f0.shape[-2:])

        # ----- 1/8 coarse stage -----
        t8_0 = _tokens(add_sine_pe_norm(feat_8c0, (ts // 8, ts // 8)))
        t8_1 = _tokens(add_sine_pe_norm(feat_8c1, (ts // 8, ts // 8)))
        mask_8c0, m8_0 = level_mask(mask0_full, *hw0_8c)
        mask_8c1, m8_1 = level_mask(mask1_full, *hw1_8c)
        t8_0, t8_1 = self.loftr_coarse_8c(t8_0, t8_1, hw0_8c, hw1_8c,
                                          mask_8c0, mask_8c1)
        # the rt/rd test gates read second-best confidences: the 1/8
        # level's for every gate, and a level's own for its rt gate and
        # the later levels' (so 2c's 1/2 rt gate makes the 1/4 level track)
        posts = [s.post_config for s in stage_configs(cfg)]
        gates_on = not train and any(p.rt is not None or p.rd is not None
                                     for p in posts)
        mc8 = cfg.match_coarse
        ds = matching.dual_softmax(t8_0, t8_1, mc8.dsmax_temperature,
                                   mask_8c0, mask_8c1,
                                   track_second=gates_on)
        matches_8c = matching.extract_coarse_matches(
            ds.conf_matrix, mc8.thr, mc8.border_rm, hw0_8c, hw1_8c,
            mc8.max_matches * capacity_scale, scale=H0 / hw0_8c[0],
            mask0=m8_0, mask1=m8_1, scale0=scale0, scale1=scale1)
        coarse = CoarseStage(ds.conf_matrix, ds.next_idx_c01, ds.next_idx_c10,
                             ds.next_conf_c01, ds.next_conf_c10, matches_8c,
                             hw0_8c, hw1_8c)
        n_stages = run_stages(cfg)
        if not n_stages:
            return MatchOutput(coarse, {}, None, matches_8c, (H0, W0),
                               (H1, W1))

        # ----- cascade stages: 1/4, then 1/2 -----
        mc = cfg.match_cascade
        backbone_maps = ((feat_4c0, feat_4c1), (feat_f0, feat_f1))
        prev = (_grid(t8_0, hw0_8c), _grid(t8_1, hw1_8c), ds.next_idx_c01,
                ds.next_idx_c10)
        pre_confs, pre_hws = [ds.next_conf_c01], [hw0_8c]
        pre_confs_s = [ds.next_conf_c01_s]
        cascades = {}
        for i in range(n_stages):
            level, name = STAGES[i]
            scfg = (cfg.coarse2, cfg.coarse3)[i]
            x0, x1, prev_idx01, prev_idx10 = prev
            f0, f1 = backbone_maps[i]
            hw0, hw1 = tuple(f0.shape[-2:]), tuple(f1.shape[-2:])
            up = getattr(self, f"up_block{i + 1}")
            if hw0 == hw1:  # both images in one BatchNorm batch
                f0, f1 = up(torch.cat([f0, f1], dim=0),
                            torch.cat([x0, x1], dim=0)).chunk(2)
            else:
                f0, f1 = up(f0, x0), up(f1, x1)
            t0 = _tokens(add_sine_pe_norm(f0, (ts // level, ts // level)))
            t1 = _tokens(add_sine_pe_norm(f1, (ts // level, ts // level)))
            mask_0, m_0 = level_mask(mask0_full, *hw0)
            mask_1, m_1 = level_mask(mask1_full, *hw1)
            t0, t1, idx01, idx10, corners01, corners10, heat = getattr(
                self, f"loftr_coarse_{name}")(t0, t1, prev_idx01, prev_idx10,
                                              hw0, hw1, hw0_8c, hw1_8c,
                                              ds.next_idx_c01,
                                              ds.next_idx_c10,
                                              ds.conf_matrix)
            ws = cm.window_softmax_matching(
                t0, t1, idx01, idx10, mc.dsmax_temperature[i], mask_0,
                mask_1, corners0=corners01, corners1=corners10, hw0=hw0,
                hw1=hw1, prop_window=scfg.window_size,
                track_second=not train and any(p.rt is not None
                                               for p in posts[i:]))
            if train:
                mask = cm.cascade_match_mask_train(
                    ws, mc.thr[i], idx01.shape[-1], hw0, hw1,
                    mc.border_rm[i], mc.double_check[i], m_0, m_1)
                m_cap = min(mc.train_pad_num_gt_min[i], mc.max_matches[i])
            else:
                pc = scfg.post_config
                s_d2d, d2d_w = stage_d2d(scfg, t0, hw0)
                sift = pc.method == "sift"
                mask = cm.cascade_match_mask_test(
                    ws, hw0, hw1, mc.test_thr[i], mc.border_rm[i],
                    pre_confs=pre_confs, pre_hws=pre_hws,
                    pre_thrs=list(mc.pre_thr[i]), post_method=pc.method,
                    post_window=pc.window_size, post_topk=pc.topk,
                    post_temperature=pc.temperature, post_stride=pc.stride,
                    double_check=mc.double_check[i], mask0_2d=m_0,
                    mask1_2d=m_1, s_d2d=s_d2d, d2d_w=d2d_w, rt=pc.rt,
                    rd=pc.rd, pre_confs_s=pre_confs_s,
                    rd_coarse=((ds.next_idx_c01, ds.next_idx_c01_s, hw0_8c)
                               if pc.rd is not None else None),
                    image0=batch["image0"] if sift else None,
                    image0_mask=mask0_full if sift else None)
                m_cap = mc.max_matches[i] * capacity_scale
            gt_idx = batch.get(f"gt_idx_{name}") if train else None
            gt_mask = batch.get(f"gt_mask_{name}") if train else None
            matches, extras = cm.extract_cascade_matches(
                ws, mask, hw0, hw1, m_cap, scale=H0 / hw0[0],
                scale0=scale0, scale1=scale1,
                priority=batch.get(f"priority_{name}"),
                idx_c01=idx01 if train else None, gt_idx_c01=gt_idx,
                gt_mask_c01=gt_mask)
            det = detector_labels(scfg, heat, ws, mask, idx01, gt_idx,
                                  gt_mask, m_cap, hw0,
                                  batch.get(f"sample_uniform_{name}"))
            cascades[name] = CascadeStage(
                ws.conf01, idx01, idx10, ws.next_idx_c01, ws.next_idx_c10,
                ws.next_conf_c01, ws.next_conf_c10, matches, hw0, hw1,
                extras.get("window_gt_label"), extras.get("window_conf"),
                *det)
            prev = (_grid(t0, hw0), _grid(t1, hw1), ws.next_idx_c01,
                    ws.next_idx_c10)
            pre_confs.append(ws.next_conf_c01)
            pre_confs_s.append(ws.next_conf_c01_s)
            pre_hws.append(hw0)

        if not runs_fine(cfg):   # 2c at stage 2: the 1/4 matches are final
            return MatchOutput(coarse, cascades, None, matches, (H0, W0),
                               (H1, W1))

        # ----- fine sub-pixel stage -----
        Wf = cfg.fine_window_size
        if n_stages > 1:                  # the 1/2 tokens, no coarse context
            ff0, ff1 = t0.reshape(B, *hw0, -1), t1.reshape(B, *hw1, -1)
            ctx0 = ctx1 = None
        else:                             # the 1/2 map, 1/4 tokens as context
            ff0, ff1 = feat_f0.permute(0, 2, 3, 1), feat_f1.permute(0, 2, 3, 1)
            ctx0, ctx1 = t0, t1
        ff0, ff1 = self.fine_preprocess(ff0, ff1, ctx0, ctx1, matches,
                                        hw0, hw1)
        ff0, ff1 = self.loftr_fine(ff0, ff1, (Wf, Wf), (Wf, Wf))
        fr = fm.fine_match(ff0, ff1)
        s1 = scale1[matches.b_ids] if scale1 is not None else None
        mk0, mk1 = fm.fine_keypoints(matches, fr.coords_norm, Wf,
                                     scale_f=H0 / hw0_f[0], scale1=s1)
        return MatchOutput(coarse, cascades, FineStage(fr.expec_f, mk0, mk1),
                           matches._replace(mkpts0=mk0, mkpts1=mk1),
                           (H0, W0), (H1, W1))
