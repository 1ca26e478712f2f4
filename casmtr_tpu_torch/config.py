"""Typed configuration tree for CasMTR-TPU.

Replaces the reference's yacs three-file merge (reference: configs/default.py:271,
configs/data/base.py:1-4) with frozen dataclasses + a dict-based `override` helper.
The option surface mirrors reference configs/default.py:1-268 one-to-one (snake_case),
so every released recipe can be expressed.

Merge order (same semantics as the reference): defaults <- model recipe <- data
recipe <- CLI overrides.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    if isinstance(x, tuple):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclass(frozen=True)
class BackboneConfig:
    """reference: configs/default.py:19-26 (_CN.LOFTR.RESNETFPN)."""
    backbone_type: str = "ResNetFPN"  # ['ResNetFPN', 'Twins', 'Ladder']
    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)   # 1/2, 1/4, 1/8
    refine_dims: Tuple[int, ...] = (64, 128, 256)   # ladder (PMT) dims
    embed_dims: Tuple[int, ...] = ()
    model_type: str = ""          # twins size preset: 'small'|'base'|'large'
    vit_path: str = ""            # pretrained ViT weights (converted)
    no_lst: bool = False


@dataclass(frozen=True)
class PostConfig:
    """Test-time keypoint filtering (reference: configs/default.py:61-66)."""
    method: Optional[str] = None          # None|'maxpool_nms'|'local_window_nms'|'softargmax_nms'|'d2d'|'sift'
    window_size: Optional[int] = None
    topk: Optional[int] = None
    rt: Optional[float] = None            # ratio test gate
    rd: Optional[float] = None            # distance gate
    temperature: float = 1.0              # softargmax_nms (reference :99)
    stride: int = 1                       # softargmax_nms: 1 or window_size


@dataclass(frozen=True)
class CoarseConfig:
    """1/8-level transformer (reference: configs/default.py:29-40)."""
    d_model: int = 256
    d_ffn: int = 256
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross") * 4
    attention: str = "linear"             # ['linear', 'full']
    block_type: str = "loftr"             # ['loftr', 'quadtree']
    attn_type: str = "B"                  # quadtree variant ['A', 'B', 'Guided']
    topks: Tuple[int, ...] = (16, 8, 8)
    relative_pe: bool = False
    next_topk: Optional[int] = None
    temp_bug_fix: bool = True


@dataclass(frozen=True)
class CascadeStageConfig:
    """Cascade-stage transformer (COARSE2/COARSE3; reference: configs/default.py:42-92)."""
    d_model: int = 192
    nhead: int = 6
    layer_names: Tuple[str, ...] = ("cross", "self", "cross")
    self_attn_type: str = "local_global"  # local_global|local|LKA|topk|POLA|linear
    window_size: int = 5                  # propagation window
    attn_window_size: Optional[int] = None  # self-attn window (defaults to window_size)
    propagation: str = "window"           # window|dilated1|topk
    sr_ratio: int = 4
    dilated: int = 1
    block_type: Optional[str] = None
    attn_type: Optional[str] = None
    relative_pe: bool = False
    topks: Optional[Tuple[int, ...]] = None
    detector: Optional[str] = None        # None|'learnable'
    detector_mode: Optional[str] = None   # None|'gumbel'|'ST'
    grid_size: Optional[int] = None
    next_topk: Optional[int] = None
    post_config: PostConfig = field(default_factory=PostConfig)


@dataclass(frozen=True)
class MatchCoarseConfig:
    """reference: configs/default.py:99-110."""
    thr: float = 0.2
    border_rm: int = 2
    match_type: str = "dual_softmax"
    dsmax_temperature: float = 0.1
    train_coarse_percent: float = 0.2
    train_pad_num_gt_min: int = 200
    sparse_spvs: bool = True
    next_topk: Optional[int] = None
    # TPU-specific: fixed capacity of the extracted match set (static shapes).
    max_matches: int = 2048


@dataclass(frozen=True)
class MatchCascadeConfig:
    """Per-cascade-level lists (reference: configs/default.py:112-124)."""
    thr: Tuple[float, ...] = (0.01,)
    pre_thr: Tuple[Any, ...] = ((0.15,),)
    test_thr: Tuple[float, ...] = (0.2,)
    border_rm: Tuple[int, ...] = (2,)
    match_type: Tuple[str, ...] = ("softmax",)
    dsmax_temperature: Tuple[float, ...] = (0.1,)
    train_pad_num_gt_min: Tuple[int, ...] = (200,)
    sparse_spvs: bool = True
    double_check: Tuple[bool, ...] = (True,)
    # TPU-specific fixed capacity per cascade level.
    max_matches: Tuple[int, ...] = (4096,)


@dataclass(frozen=True)
class FineConfig:
    """reference: configs/default.py:127-133."""
    d_model: int = 128
    d_ffn: int = 128
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross")
    attention: str = "linear"
    block_type: str = "loftr"


@dataclass(frozen=True)
class LossConfig:
    """reference: configs/default.py:137-157."""
    coarse_type: str = "focal"
    coarse_weight: float = 1.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    cascade_type: str = "cross_entropy"
    cascade_weight: float = 1.0
    detector_weight: float = 2.0
    fine_type: str = "l2_with_std"
    fine_weight: float = 1.0
    fine_correct_thr: float = 1.0


@dataclass(frozen=True)
class LoftrConfig:
    """Top-level model config (reference: configs/default.py:5-16,94-96)."""
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    resolution: Tuple[int, ...] = (8, 2)
    fine_window_size: int = 5
    fine_concat_coarse_feat: bool = True
    is_rgb: bool = False
    cascade: bool = False
    train_size: int = 704
    training_stage: int = 9
    bn_fix: bool = False
    quadtree_path: str = ""
    coarse: CoarseConfig = field(default_factory=CoarseConfig)
    coarse2: CascadeStageConfig = field(default_factory=CascadeStageConfig)
    coarse3: CascadeStageConfig = field(
        default_factory=lambda: CascadeStageConfig(d_model=64))
    coarse_level: int = 8
    fine_level: int = 2
    cascade_levels: Tuple[int, ...] = (4,)
    match_coarse: MatchCoarseConfig = field(default_factory=MatchCoarseConfig)
    match_cascade: MatchCascadeConfig = field(default_factory=MatchCascadeConfig)
    fine: FineConfig = field(default_factory=FineConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    # TPU-specific: rematerialize transformer layers in backward (trades one
    # recompute for activation memory; needed above ~704^2 on 16GB chips)
    remat: bool = True


@dataclass(frozen=True)
class DatasetConfig:
    """reference: configs/default.py:161-193."""
    trainval_data_source: Optional[str] = None  # ['ScanNet', 'MegaDepth']
    train_data_root: Optional[str] = None
    train_pose_root: Optional[str] = None
    train_npz_root: Optional[str] = None
    train_list_path: Optional[str] = None
    train_intrinsic_path: Optional[str] = None
    val_data_root: Optional[str] = None
    val_pose_root: Optional[str] = None
    val_npz_root: Optional[str] = None
    val_list_path: Optional[str] = None
    val_intrinsic_path: Optional[str] = None
    test_data_source: Optional[str] = None
    test_data_root: Optional[str] = None
    test_pose_root: Optional[str] = None
    test_npz_root: Optional[str] = None
    test_list_path: Optional[str] = None
    test_intrinsic_path: Optional[str] = None
    min_overlap_score_train: float = 0.4
    min_overlap_score_test: float = 0.0
    augmentation_type: Optional[str] = None
    mgdpt_img_resize: int = 640
    mgdpt_img_pad: bool = True
    mgdpt_depth_pad: bool = True
    mgdpt_df: int = 64


@dataclass(frozen=True)
class TrainerConfig:
    """reference: configs/default.py:196-268."""
    world_size: int = 1
    canonical_bs: int = 64
    canonical_lr: float = 6e-3
    scaling: Optional[float] = None
    true_lr: Optional[float] = None
    optimizer: str = "adamw"
    adam_decay: float = 0.0
    adamw_decay: float = 0.1
    vit_lr_scale: float = 0.5
    warmup_type: str = "linear"
    warmup_ratio: float = 0.0
    warmup_step: int = 4800
    warmup_step_stages: int = 0
    warmup_ratio_stages: float = 0.0
    scheduler: str = "MultiStepLR"
    scheduler_interval: str = "epoch"
    min_lr: float = 1e-7
    steps_range: Tuple[int, ...] = (41400, 120000)
    mslr_milestones: Tuple[int, ...] = (3, 6, 9, 12)
    mslr_gamma: float = 0.5
    cosa_tmax: int = 30
    elr_gamma: float = 0.999992
    enable_plotting: bool = True
    n_val_pairs_to_plot: int = 32
    plot_mode: str = "evaluation"
    plot_matches_alpha: str = "dynamic"
    epi_err_thr: float = 5e-4
    pose_geo_model: str = "E"
    pose_estimation_method: str = "RANSAC"
    ransac_pixel_thr: float = 0.5
    ransac_conf: float = 0.99999
    ransac_max_iters: int = 10000
    use_magsacpp: bool = False
    data_sampler: str = "scene_balance"
    n_samples_per_subset: int = 200
    sb_subset_sample_replacement: bool = True
    sb_subset_shuffle: bool = True
    sb_repeat: int = 1
    rdm_replacement: bool = True
    rdm_num_samples: Optional[int] = None
    ema: bool = False
    test_ema: bool = False
    ema_beta: float = 0.997
    ema_warmup: int = 10000
    gradient_clipping: float = 0.5
    seed: int = 66


@dataclass(frozen=True)
class Config:
    """Root config tree (the analogue of the merged yacs CfgNode)."""
    loftr: LoftrConfig = field(default_factory=LoftrConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


# ---------------------------------------------------------------------------
# override / merge machinery
# ---------------------------------------------------------------------------

def override(cfg, updates: dict):
    """Return a copy of a (possibly nested) frozen dataclass with `updates` applied.

    Keys may be nested dicts ({'coarse': {'d_model': 320}}) or dotted strings
    ('coarse.d_model'). Lists are converted to tuples so the config stays hashable.
    """
    # Expand dotted keys into nested dicts.
    nested: dict = {}
    for k, v in updates.items():
        parts = k.split(".")
        d = nested
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        if isinstance(d.get(parts[-1]), dict) and isinstance(v, dict):
            d[parts[-1]].update(v)
        else:
            d[parts[-1]] = v

    def _apply(obj, upd):
        if not dataclasses.is_dataclass(obj):
            return _tuplify(upd)
        fields = {f.name: f for f in dataclasses.fields(obj)}
        changes = {}
        for k, v in upd.items():
            if k not in fields:
                raise KeyError(
                    f"unknown config key '{k}' for {type(obj).__name__}; "
                    f"valid keys: {sorted(fields)}")
            cur = getattr(obj, k)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                changes[k] = _apply(cur, v)
            else:
                changes[k] = _tuplify(v)
        return dataclasses.replace(obj, **changes)

    return _apply(cfg, nested)


def to_dict(cfg) -> dict:
    """Recursively convert a config tree to plain python (for dumping)."""
    return dataclasses.asdict(cfg)


def dump(cfg, path: str):
    """Dump full config to a run dir for reproducibility
    (mirrors reference lightning_cascade.py:119-122)."""
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=str)


def load(path: str) -> Config:
    """Load a config dumped by ``dump`` (used by stage resume to recover the
    checkpointed run's trainer/schedule settings)."""
    with open(path) as f:
        d = json.load(f)
    return override(Config(), d)


def get_cfg_defaults() -> Config:
    return Config()
