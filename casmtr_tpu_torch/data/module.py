"""The multi-scene data module (counterpart of casmtr_tpu/data/module.py):
each split a ConcatDataset of per-scene datasets, built in threads, with
the training scenes split across processes."""

from __future__ import annotations

import os
import os.path as osp
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from casmtr_tpu_torch.config import Config
from casmtr_tpu_torch.data.loader import (ConcatDataset, DataLoader,
                                          RandomConcatSampler,
                                          get_local_split)
from casmtr_tpu_torch.data.megadepth import MegaDepthDataset
from casmtr_tpu_torch.data.scannet import ScanNetDataset


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip().split(" ")[0] for ln in f if ln.strip()]


class MultiSceneDataModule:
    def __init__(self, config: Config, world_size: int = 1, rank: int = 0,
                 build_workers: Optional[int] = None):
        self.config = config
        self.world_size = world_size
        self.rank = rank
        self.seed = config.trainer.seed
        # the reference's 0.9 x cores per local process
        self.build_workers = build_workers if build_workers is not None else (
            max(1, int(len(os.sched_getaffinity(0)) * 0.9)))

    def _build_split(self, data_source, root, npz_root, list_path,
                     intrinsic_path, mode, min_overlap):
        d = self.config.dataset
        names = _read_list(list_path)
        if mode == "train" and self.world_size > 1:
            # each process takes its own scenes, not a replica of all
            names = get_local_split(names, self.world_size, self.rank,
                                    self.seed)

        def build_one(name):
            npz_path = osp.join(npz_root, name)
            if not npz_path.endswith(".npz"):
                npz_path += ".npz"
            if not osp.exists(npz_path):
                return ("missing", npz_path)
            if data_source == "MegaDepth":
                return ("ok", MegaDepthDataset(
                    root, npz_path, mode=mode,
                    min_overlap_score=min_overlap,
                    img_resize=d.mgdpt_img_resize, df=d.mgdpt_df,
                    img_padding=d.mgdpt_img_pad,
                    depth_padding=d.mgdpt_depth_pad,
                    is_rgb=self.config.loftr.is_rgb))
            if data_source == "ScanNet":
                return ("ok", ScanNetDataset(
                    root, npz_path, intrinsic_path, mode=mode,
                    min_overlap_score=min_overlap,
                    is_rgb=self.config.loftr.is_rgb))
            raise ValueError(data_source)

        # a scene's build is npz reading and numpy filtering: threads
        workers = min(self.build_workers, max(len(names), 1))
        if workers > 1:
            with ThreadPoolExecutor(workers) as ex:
                results = list(ex.map(build_one, names))
        else:
            results = [build_one(n) for n in names]
        missing = [p for tag, p in results if tag == "missing"]
        datasets = [ds for tag, ds in results if tag == "ok"]
        if missing:
            warnings.warn(
                f"{mode}: {len(missing)} of {len(names)} scene npz files "
                f"missing under {npz_root} (first: {missing[0]})",
                RuntimeWarning)
        if not datasets:
            raise FileNotFoundError(
                f"no scene npz files found for {mode}: checked {len(names)} "
                f"names from {list_path} under {npz_root}")
        # the scene-balanced sampler cannot draw from a scene without pairs
        # (every pair below the overlap threshold)
        nonempty = [ds for ds in datasets if len(ds) > 0]
        if len(nonempty) < len(datasets):
            warnings.warn(
                f"{mode}: dropped {len(datasets) - len(nonempty)} scenes "
                f"with zero usable pairs", RuntimeWarning)
        return ConcatDataset(nonempty)

    def train_dataset(self):
        d = self.config.dataset
        return self._build_split(d.trainval_data_source, d.train_data_root,
                                 d.train_npz_root, d.train_list_path,
                                 d.train_intrinsic_path, "train",
                                 d.min_overlap_score_train)

    def val_dataset(self):
        d = self.config.dataset
        return self._build_split(d.trainval_data_source, d.val_data_root,
                                 d.val_npz_root, d.val_list_path,
                                 d.val_intrinsic_path, "val",
                                 d.min_overlap_score_test)

    def test_dataset(self):
        d = self.config.dataset
        return self._build_split(d.test_data_source, d.test_data_root,
                                 d.test_npz_root, d.test_list_path,
                                 d.test_intrinsic_path, "test",
                                 d.min_overlap_score_test)

    def train_loader(self, batch_size: int, num_workers: int = 4):
        t = self.config.trainer
        ds = self.train_dataset()
        sampler = RandomConcatSampler(
            ds, t.n_samples_per_subset,
            subset_replacement=t.sb_subset_sample_replacement,
            shuffle=t.sb_subset_shuffle, repeat=t.sb_repeat, seed=t.seed)
        return DataLoader(ds, sampler, batch_size=batch_size,
                          num_workers=num_workers, drop_last=True)

    def eval_loader(self, dataset, batch_size: int = 1, num_workers: int = 4):
        return DataLoader(dataset, None, batch_size=batch_size,
                          num_workers=num_workers, drop_last=False)
