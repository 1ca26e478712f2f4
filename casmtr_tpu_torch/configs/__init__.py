"""Named model & data recipes, mirroring reference configs/model_configs/ and
configs/data/. Each recipe is a dict of overrides applied on top of the defaults
via `casmtr_tpu_torch.config.override` (merge order matches reference
configs/data/base.py:1-4: defaults <- model <- data <- CLI)."""

from casmtr_tpu_torch.config import Config, get_cfg_defaults, override

# -----------------------------------------------------------------------------
# Model recipes
# -----------------------------------------------------------------------------

# CasMTR-4c outdoor (reference: configs/model_configs/outdoor/
# loftr_ds_quadtree_cas_twins_large_stage3.py:1-81)
OUTDOOR_CASMTR_4C = {
    "loftr": {
        "backbone": {
            "backbone_type": "Twins",
            "initial_dim": 64,
            "block_dims": [64, 128, 256],
            "model_type": "large",
            "vit_path": "pretrained_weights/alt_gvt_large.npz",
        },
        "resolution": [8, 4, 2],
        "coarse": {
            "d_model": 256,
            "block_type": "quadtree",
            "attn_type": "B",
            "topks": [32, 16, 8],
            "layer_names": ["self", "cross"] * 3,
            "relative_pe": False,
        },
        "coarse2": {
            "d_model": 128,
            "nhead": 4,
            "layer_names": ["cross", "self", "cross", "self"],
            "self_attn_type": "local",
            "window_size": 5,
            "attn_window_size": 7,
            "propagation": "window",
            "sr_ratio": 4,
            "dilated": 1,
            "relative_pe": False,
            "topks": [16, 8],
            "grid_size": 4,
            "post_config": {"method": "maxpool_nms", "window_size": 5},
        },
        "fine": {
            "d_model": 64, "d_ffn": 64, "nhead": 2,
            "layer_names": ["self", "cross"], "attention": "vanilla",
        },
        "match_coarse": {
            "match_type": "dual_softmax", "sparse_spvs": False, "thr": 0.2,
            "border_rm": 0, "train_coarse_percent": 0.3,
        },
        "match_cascade": {
            "thr": [0.0101], "pre_thr": [[0.2]], "test_thr": [0.2],
            "border_rm": [2], "double_check": [True], "match_type": ["softmax"],
            "dsmax_temperature": [1.0], "train_pad_num_gt_min": [4096],
            "max_matches": [8192],
        },
        "loss": {
            "coarse_weight": 1.0, "cascade_weight": 1.0,
            "cascade_type": "focal", "fine_weight": 1.0, "detector_weight": 2.0,
        },
        "cascade": True,
        "coarse_level": 8,
        "fine_level": 2,
        "cascade_levels": [4],
        "is_rgb": True,
        "train_size": 704,
    },
    "trainer": {
        "canonical_lr": 8e-3, "warmup_step": 1875, "warmup_ratio": 0.1,
        "mslr_milestones": [8, 12, 16, 20, 24], "ransac_pixel_thr": 0.5,
        "optimizer": "adamw", "adamw_decay": 0.01,
    },
}

# CasMTR-2c outdoor (reference: …stage4.py:1-106); adds the 1/2 cascade stage.
OUTDOOR_CASMTR_2C = {
    "loftr": {
        **OUTDOOR_CASMTR_4C["loftr"],
        "coarse2": {
            **OUTDOOR_CASMTR_4C["loftr"]["coarse2"],
            "self_attn_type": "local",
            "sr_ratio": 2,
            "topks": None,
            "post_config": {"method": None, "window_size": None},
        },
        "coarse3": {
            "d_model": 64,
            "nhead": 2,
            "layer_names": ["cross", "self", "cross"],
            "self_attn_type": "local",
            "window_size": 5,
            "attn_window_size": 7,
            "propagation": "window",
            "sr_ratio": 4,
            "dilated": 1,
            "relative_pe": False,
            "grid_size": 4,
            "post_config": {"method": "maxpool_nms", "window_size": 5},
        },
        "match_cascade": {
            "thr": [0.0101, 0.0101], "pre_thr": [[0.2], [0.2, 0.2]],
            "test_thr": [0.2, 0.2], "border_rm": [1, 2],
            "double_check": [True, True], "match_type": ["softmax", "softmax"],
            "dsmax_temperature": [1.0, 1.0],
            "train_pad_num_gt_min": [4096, 8192],
            "max_matches": [8192, 8192],
        },
        "cascade_levels": [4, 2],
        "fine_concat_coarse_feat": False,
    },
    "trainer": {
        **OUTDOOR_CASMTR_4C["trainer"],
        "mslr_milestones": [8, 12, 15, 18, 21, 24],
    },
}

# CasMTR-4c indoor (reference: configs/model_configs/indoor/
# loftr_ds_quadtree_cas_stage3.py:1-81): ResNetFPN, POLA self-attn, relative PE.
INDOOR_CASMTR_4C = {
    "loftr": {
        "backbone": {
            "backbone_type": "ResNetFPN",
            "initial_dim": 128,
            "block_dims": [128, 196, 256],
            "refine_dims": [64, 128, 256],
        },
        "resolution": [8, 4, 2],
        "coarse": {
            "d_model": 256, "block_type": "quadtree", "attn_type": "B",
            "topks": [32, 16, 16],
        },
        "coarse2": {
            "d_model": 128, "nhead": 4,
            "layer_names": ["self", "cross", "self", "cross"],
            "self_attn_type": "POLA", "window_size": 5, "attn_window_size": 7,
            "propagation": "window", "sr_ratio": 2, "dilated": 1,
            "relative_pe": True, "grid_size": 4,
            "post_config": {"method": None},
        },
        "fine": {
            "d_model": 64, "d_ffn": 64, "nhead": 2,
            "layer_names": ["self", "cross"], "attention": "vanilla",
        },
        "match_coarse": {
            "match_type": "dual_softmax", "sparse_spvs": False, "thr": 0.2,
            "border_rm": 0, "train_coarse_percent": 0.3,
        },
        "match_cascade": {
            "thr": [0.0, 0.0], "pre_thr": [[0.2, 0.1]], "test_thr": [0.1],
            "border_rm": [1], "double_check": [True], "match_type": ["softmax"],
            "dsmax_temperature": [1.0], "train_pad_num_gt_min": [8192],
            "max_matches": [8192],
        },
        "loss": {"cascade_type": "focal"},
        "cascade": True,
        "cascade_levels": [4],
        "is_rgb": True,
        "train_size": 640,
    },
    "trainer": {
        "canonical_bs": 32, "canonical_lr": 3e-3, "warmup_step": 500,
        "warmup_ratio": 0.0, "warmup_step_stages": 1000,
        "warmup_ratio_stages": 0.01, "mslr_milestones": [2, 3, 4],
        "optimizer": "adamw", "adamw_decay": 0.01,
    },
}

# Plain QuadTree-LoFTR baseline (reference: configs/model_configs/indoor/
# loftr_ds_quadtree.py:1-16)
QUADTREE_BASELINE = {
    "loftr": {
        "resolution": [8, 2],
        "coarse": {
            "d_model": 256, "block_type": "quadtree", "attn_type": "B",
            "topks": [16, 8, 8],
        },
        "match_coarse": {"match_type": "dual_softmax", "sparse_spvs": False,
                         "border_rm": 0},
        "cascade": False,
    },
}

# -----------------------------------------------------------------------------
# Data recipes (reference: configs/data/*.py)
# -----------------------------------------------------------------------------

MEGADEPTH_TEST_1500 = {
    "dataset": {
        "test_data_source": "MegaDepth",
        "test_data_root": "data/megadepth/test",
        "test_npz_root": "data/megadepth/index/scene_info_val_1500",
        "test_list_path": "data/megadepth/index/trainvaltest_list/val_list.txt",
        "min_overlap_score_test": 0.0,
        "mgdpt_img_resize": 832,
        "mgdpt_img_pad": True,
        "mgdpt_depth_pad": True,
        "mgdpt_df": 64,
    },
    "trainer": {"epi_err_thr": 1e-4},
}

SCANNET_TEST_1500 = {
    "dataset": {
        "test_data_source": "ScanNet",
        "test_data_root": "data/scannet/test",
        "test_npz_root": "data/scannet/index",
        "test_list_path": "data/scannet/index/scene_data/test_list/scannet_test.txt",
        "test_intrinsic_path": "data/scannet/index/intrinsics.npz",
        "min_overlap_score_test": 0.0,
    },
    "trainer": {"epi_err_thr": 5e-4},
}

MEGADEPTH_TRAINVAL_704 = {
    "dataset": {
        "trainval_data_source": "MegaDepth",
        "train_data_root": "data/megadepth/train",
        "train_npz_root": "data/megadepth/index/scene_info_0.1_0.7",
        "train_list_path": "data/megadepth/index/trainvaltest_list/train_list.txt",
        "val_data_root": "data/megadepth/test",
        "val_npz_root": "data/megadepth/index/scene_info_val_1500",
        "val_list_path": "data/megadepth/index/trainvaltest_list/val_list.txt",
        "min_overlap_score_train": 0.0,
        "mgdpt_img_resize": 704,
    },
    "trainer": {"epi_err_thr": 1e-4},
}

SCANNET_TRAINVAL = {
    "dataset": {
        "trainval_data_source": "ScanNet",
        "train_data_root": "data/scannet/train",
        "train_npz_root": "data/scannet/index/scene_data/train",
        "train_list_path": "data/scannet/index/scene_data/train_list/scannet_all.txt",
        "train_intrinsic_path": "data/scannet/index/intrinsics.npz",
        "val_data_root": "data/scannet/test",
        "val_npz_root": "data/scannet/index/scene_data/val",
        "val_list_path": "data/scannet/index/scene_data/val_list/scannet_val.txt",
        "val_intrinsic_path": "data/scannet/index/intrinsics.npz",
        "min_overlap_score_train": 0.4,
    },
    "trainer": {"epi_err_thr": 5e-4},
}

# The PUBLISHED indoor recipe is internally inconsistent — BLOCK_DIMS[1]=196
# feeds the 1/4 cascade stage whose d_model is 128, so the reference's own
# forward crashes the moment stage >= 2 activates it (see
# tests/test_ref_parity.py::test_ref_full_tree_indoor_4c).  This variant is
# the unique dims assignment that keeps every module of the recipe alive and
# shape-consistent; everything else is identical.  Verified training
# end-to-end on device (docs/evidence_r5/indoor*.log).
INDOOR_CASMTR_4C_RUNNABLE = {
    "loftr": {
        **INDOOR_CASMTR_4C["loftr"],
        "backbone": {
            **INDOOR_CASMTR_4C["loftr"]["backbone"],
            "initial_dim": 64,
            "block_dims": [64, 128, 256],
        },
    },
    "trainer": INDOOR_CASMTR_4C["trainer"],
}

MODEL_RECIPES = {
    "outdoor_casmtr_4c": OUTDOOR_CASMTR_4C,
    "outdoor_casmtr_2c": OUTDOOR_CASMTR_2C,
    "indoor_casmtr_4c": INDOOR_CASMTR_4C,
    "indoor_casmtr_4c_runnable": INDOOR_CASMTR_4C_RUNNABLE,
    "quadtree_baseline": QUADTREE_BASELINE,
}

DATA_RECIPES = {
    "megadepth_test_1500": MEGADEPTH_TEST_1500,
    "scannet_test_1500": SCANNET_TEST_1500,
    "megadepth_trainval_704": MEGADEPTH_TRAINVAL_704,
    "scannet_trainval": SCANNET_TRAINVAL,
}


def build_config(model_recipe=None, data_recipe=None, overrides=None) -> Config:
    """Three-layer merge: defaults <- model <- data <- CLI overrides."""
    cfg = get_cfg_defaults()
    if model_recipe is not None:
        if isinstance(model_recipe, str):
            model_recipe = MODEL_RECIPES[model_recipe]
        cfg = override(cfg, model_recipe)
    if data_recipe is not None:
        if isinstance(data_recipe, str):
            data_recipe = DATA_RECIPES[data_recipe]
        cfg = override(cfg, data_recipe)
    if overrides:
        cfg = override(cfg, overrides)
    return cfg
