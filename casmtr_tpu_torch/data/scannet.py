"""ScanNet per-scene dataset (counterpart of casmtr_tpu/data/scannet.py):
fixed 640x480 frames, per-frame poses composed from txt files, shared
per-scene intrinsics; NHWC numpy outputs."""

from __future__ import annotations

import os.path as osp

import numpy as np

from casmtr_tpu_torch.data.io import (read_scannet_depth, read_scannet_image,
                                      read_scannet_pose)


class ScanNetDataset:
    def __init__(self, root_dir: str, npz_path: str, intrinsic_path: str,
                 mode: str = "train", min_overlap_score: float = 0.4,
                 pose_dir=None, is_rgb: bool = True, **kwargs):
        self.root_dir = root_dir
        self.pose_dir = pose_dir or root_dir
        self.mode = mode
        self.is_rgb = is_rgb
        with np.load(npz_path) as data:
            self.data_names = data["name"]
            # the score filter applies in training only (the reference's
            # guard `mode not in ['val' or 'test']` reads as ['val'] and
            # filters the test split too; released test npzs hold no
            # 'score', so the two agree there)
            if "score" in data.files and mode not in ("val", "test"):
                self.data_names = self.data_names[
                    data["score"] > min_overlap_score]
        self.intrinsics = dict(np.load(intrinsic_path))

    def __len__(self):
        return len(self.data_names)

    def _abs_pose(self, scene, name):
        return read_scannet_pose(
            osp.join(self.pose_dir, scene, "pose", f"{name}.txt"))

    def __getitem__(self, idx):
        scene_name, scene_sub, stem0, stem1 = self.data_names[idx]
        scene = f"scene{int(scene_name):04d}_{int(scene_sub):02d}"
        img0 = read_scannet_image(
            osp.join(self.root_dir, scene, "color", f"{stem0}.jpg"),
            gray=not self.is_rgb)
        img1 = read_scannet_image(
            osp.join(self.root_dir, scene, "color", f"{stem1}.jpg"),
            gray=not self.is_rgb)
        if self.mode in ("train", "val"):
            depth0 = read_scannet_depth(
                osp.join(self.root_dir, scene, "depth", f"{stem0}.png"))
            depth1 = read_scannet_depth(
                osp.join(self.root_dir, scene, "depth", f"{stem1}.png"))
        else:
            depth0 = depth1 = np.zeros((0,), np.float32)
        K = np.asarray(self.intrinsics[scene], np.float32).reshape(3, 3)
        T_0to1 = np.asarray(
            self._abs_pose(scene, stem1) @ np.linalg.inv(
                self._abs_pose(scene, stem0)), np.float32)
        T_1to0 = np.linalg.inv(T_0to1).astype(np.float32)
        return {
            "image0": img0, "image1": img1,
            "depth0": depth0, "depth1": depth1,
            "T_0to1": T_0to1, "T_1to0": T_1to0,
            "K0": K, "K1": K,
            "dataset_name": "ScanNet",
            "scene_id": scene,
            "pair_id": idx,
            "pair_names": (osp.join(scene, "color", f"{stem0}.jpg"),
                           osp.join(scene, "color", f"{stem1}.jpg")),
        }
