"""MegaDepth per-scene dataset (counterpart of casmtr_tpu/data/megadepth.py):
plain __len__/__getitem__ over a scene npz, NHWC numpy outputs."""

from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from casmtr_tpu_torch.data.io import read_megadepth_depth, read_megadepth_image


class MegaDepthDataset:
    def __init__(self, root_dir: str, npz_path: str, mode: str = "train",
                 min_overlap_score: float = 0.4,
                 img_resize: Optional[int] = None, df: Optional[int] = None,
                 img_padding: bool = False, depth_padding: bool = False,
                 is_rgb: bool = True, fixed_pad: bool = True, **kwargs):
        self.root_dir = root_dir
        self.mode = mode
        self.scene_id = osp.basename(npz_path).split(".")[0]
        if mode == "test":
            min_overlap_score = 0.0
        info = np.load(npz_path, allow_pickle=True)
        self.scene_info = {k: info[k] for k in info.files
                           if k != "pair_infos"}
        self.pair_infos = [p for p in info["pair_infos"]
                           if p[1] > min_overlap_score]
        self.img_resize = img_resize
        self.df = df
        self.img_padding = img_padding
        # one shape for every sample: pad each image to the same square
        # canvas (the padded region is masked)
        self.pad_size = img_resize if (fixed_pad and img_padding) else None
        self.depth_max_size = 2000 if depth_padding else None
        self.is_rgb = is_rgb

    def __len__(self):
        return len(self.pair_infos)

    def __getitem__(self, idx):
        (idx0, idx1), overlap, _ = self.pair_infos[idx]
        name0 = osp.join(self.root_dir, self.scene_info["image_paths"][idx0])
        name1 = osp.join(self.root_dir, self.scene_info["image_paths"][idx1])
        img0, mask0, scale0 = read_megadepth_image(
            name0, self.img_resize, self.df, self.img_padding,
            gray=not self.is_rgb, pad_size=self.pad_size)
        img1, mask1, scale1 = read_megadepth_image(
            name1, self.img_resize, self.df, self.img_padding,
            gray=not self.is_rgb, pad_size=self.pad_size)

        if self.mode in ("train", "val"):
            depth0 = read_megadepth_depth(
                osp.join(self.root_dir, self.scene_info["depth_paths"][idx0]),
                pad_to=self.depth_max_size)
            depth1 = read_megadepth_depth(
                osp.join(self.root_dir, self.scene_info["depth_paths"][idx1]),
                pad_to=self.depth_max_size)
        else:
            depth0 = depth1 = np.zeros((0,), np.float32)

        K0 = np.asarray(self.scene_info["intrinsics"][idx0],
                        np.float32).reshape(3, 3)
        K1 = np.asarray(self.scene_info["intrinsics"][idx1],
                        np.float32).reshape(3, 3)
        T0 = self.scene_info["poses"][idx0]
        T1 = self.scene_info["poses"][idx1]
        T_0to1 = np.asarray(T1 @ np.linalg.inv(T0), np.float32)[:4, :4]
        T_1to0 = np.linalg.inv(T_0to1).astype(np.float32)

        data = {
            "image0": img0, "image1": img1,       # [h, w, 3]
            "depth0": depth0, "depth1": depth1,   # [h, w]
            "T_0to1": T_0to1, "T_1to0": T_1to0,
            "K0": K0, "K1": K1,
            "scale0": scale0, "scale1": scale1,
            "dataset_name": "MegaDepth",
            "scene_id": self.scene_id,
            "pair_id": idx,
            "pair_names": (self.scene_info["image_paths"][idx0],
                           self.scene_info["image_paths"][idx1]),
        }
        if mask0 is not None:
            data["mask0"] = mask0
            data["mask1"] = mask1
        return data
