"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py): the
tiny CasMTR-4c and CasMTR-2c configurations built in both packages, flax
variables made non-trivial and handed to the port as nested dicts of numpy
arrays, and the chunk rule and child rows of the CPU models of the chunked
CUDA kernels."""

import re
from pathlib import Path

import jax
import numpy as np

CHUNK_SRC = (Path(__file__).resolve().parents[1] / "casmtr_tpu_torch"
             / "csrc" / "block_chunk.cuh")


def kernel_chunk(H):
    """Candidates per chunk for H heads, by the chunked kernels' rule
    (``chunk_rows`` in csrc/block_chunk.cuh): kChunkPairs / H rounded down
    to a power of two, at most 32, at least 1."""
    pairs = int(re.search(r"kChunkPairs = (\d+);",
                          CHUNK_SRC.read_text()).group(1))
    c = min(32, max(1, pairs // H))
    return 1 << (c.bit_length() - 1)


def child_rows(grid_q):
    """Query rows [P, 4] of each parent's 2x2 children (row-major)."""
    h0, w0 = grid_q
    pr, pc = np.divmod(np.arange((h0 // 2) * (w0 // 2)), w0 // 2)
    return np.stack([(2 * pr + f // 2) * w0 + 2 * pc + f % 2
                     for f in range(4)], -1)


def tiny_4c_overrides(train_size: int = 128, zero_thresholds: bool = False):
    """``__graft_entry__._flagship_cfg(train_size)`` with
    ``_tiny_model_overrides((4,))`` on top (the full 4c wiring at tiny
    widths); ``zero_thresholds`` lets every stage yield matches."""
    loftr = {
        "train_size": train_size,
        "backbone": {"backbone_type": "Twins", "model_type": "small",
                     "initial_dim": 8, "block_dims": [8, 12, 16],
                     "refine_dims": [8, 12, 16]},
        "coarse": {"d_model": 16, "nhead": 2, "topks": [4, 4, 4],
                   "layer_names": ["self", "cross"]},
        "coarse2": {"d_model": 12, "nhead": 2, "window_size": 3,
                    "attn_window_size": 3,
                    "layer_names": ["cross", "self", "cross"]},
        "fine": {"d_model": 8, "nhead": 2},
        "match_coarse": {"max_matches": 16},
        "match_cascade": {"train_pad_num_gt_min": [16], "max_matches": [32]},
    }
    if zero_thresholds:
        loftr["match_coarse"]["thr"] = 0.0
        loftr["match_cascade"].update(test_thr=[0.0], pre_thr=[[0.0]])
    return {"loftr": loftr}


def tiny_2c_overrides(train_size: int = 128, zero_thresholds: bool = False):
    """``_tiny_model_overrides((4, 2))`` of __graft_entry__ with the train
    size on top (the full 2c wiring at tiny widths); ``zero_thresholds``
    lets every stage yield matches."""
    ov = tiny_4c_overrides(train_size)
    loftr = ov["loftr"]
    loftr.update(cascade_levels=[4, 2], training_stage=3,
                 fine_concat_coarse_feat=False)
    loftr["coarse3"] = {"d_model": 8, "nhead": 2, "window_size": 3,
                        "attn_window_size": 3,
                        "layer_names": ["cross", "self"]}
    loftr["match_cascade"] = {
        "thr": [0.0, 0.0], "pre_thr": [[0.0], [0.0, 0.0]],
        "test_thr": [0.2, 0.2], "border_rm": [2, 2],
        "double_check": [True, True], "match_type": ["softmax"] * 2,
        "dsmax_temperature": [1.0, 1.0],
        "train_pad_num_gt_min": [16, 16], "max_matches": [32, 32]}
    if zero_thresholds:
        loftr["match_coarse"]["thr"] = 0.0
        loftr["match_cascade"]["test_thr"] = [0.0, 0.0]
    return ov


def configs(overrides, recipe: str = "outdoor_casmtr_4c"):
    """The same recipe built by both packages: (jax_cfg, torch_cfg)."""
    from casmtr_tpu.configs import build_config as jax_build
    from casmtr_tpu_torch.configs import build_config as torch_build
    return (jax_build(recipe, overrides=overrides),
            torch_build(recipe, overrides=overrides))


def jitter(variables, seed: int = 0):
    """Perturb every flax leaf so that no parameter keeps its initial
    constant (LayerNorm/BatchNorm scales of 1, zero biases, running mean 0
    and variance 1): a wrong name or layout mapping then shows up in the
    outputs.  Returns nested dicts of numpy float32 arrays."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return 1.0 + 0.2 * np.abs(noise)
        if path[-1].key == "mean":
            return 0.1 * noise
        return x + 0.05 * noise

    return jax.tree_util.tree_map_with_path(
        leaf, jax.tree_util.tree_map(np.asarray, dict(variables)))
