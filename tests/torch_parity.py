"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py): the
tiny CasMTR-4c, CasMTR-2c, quadtree_baseline (on its own backbone and on
the two 1/16 ones), indoor and model-zoo configurations built in both
packages, flax variables made non-trivial and handed to the port as nested
dicts of numpy arrays, and the chunk rule and child rows of the CPU models
of the chunked CUDA kernels."""

import contextlib
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


def tiny_baseline_overrides(train_size: int = 128,
                            zero_thresholds: bool = False,
                            attn_type: str = "B"):
    """``quadtree_baseline`` at tiny widths: ResNetFPN_8_2 (gray) 8 / [8,
    12, 16], a self and a cross quadtree layer of d 16, 2 heads, topks 4
    (quadtree attention ``attn_type``), fine d 8, 2 heads; the recipe's
    wiring otherwise.  ``zero_thresholds`` lets every match through."""
    loftr = {
        "train_size": train_size,
        "backbone": {"initial_dim": 8, "block_dims": [8, 12, 16]},
        "coarse": {"d_model": 16, "nhead": 2, "topks": [4, 4, 4],
                   "layer_names": ["self", "cross"], "attn_type": attn_type},
        "fine": {"d_model": 8, "nhead": 2},
        "match_coarse": {"max_matches": 16},
    }
    if zero_thresholds:
        loftr["match_coarse"]["thr"] = 0.0
    return {"loftr": loftr}


def tiny_coarse16_overrides(backbone: str, train_size: int = 128,
                            zero_thresholds: bool = False):
    """``quadtree_baseline`` on a 1/16 backbone at tiny widths: ``"R16"``
    is ResNetFPN_16_4 (gray) 8 / [8, 12, 16, 24] at resolution (16, 4),
    ``"T16"`` TwinsFPN_16_8_4_2 (Twins ``small``, RGB) 8 / [8, 12, 16, 24]
    at (16, 8, 4, 2); both at coarse_level 16, a self and a cross quadtree
    layer of d 24, 2 heads, topks 4, and a fine stack of 2 heads at the
    finest map's width (12 at 1/4, 8 at 1/2).  The 1/16 grid of an image
    of side 64n is 4n, so three quadtree levels need sides of 128 and up.
    ``zero_thresholds`` lets every match through."""
    twins = backbone == "T16"
    loftr = {
        "train_size": train_size,
        "backbone": {"backbone_type": "Twins" if twins else "ResNetFPN",
                     "initial_dim": 8, "block_dims": [8, 12, 16, 24]},
        "resolution": [16, 8, 4, 2] if twins else [16, 4],
        "coarse_level": 16,
        "coarse": {"d_model": 24, "nhead": 2, "topks": [4, 4, 4],
                   "layer_names": ["self", "cross"]},
        "fine": {"d_model": 8 if twins else 12,
                 "d_ffn": 8 if twins else 12, "nhead": 2},
        "match_coarse": {"max_matches": 16},
    }
    if twins:
        loftr["backbone"]["model_type"] = "small"
        loftr["is_rgb"] = True
    if zero_thresholds:
        loftr["match_coarse"]["thr"] = 0.0
    return {"loftr": loftr}


def tiny_indoor_overrides(train_size: int = 128,
                          zero_thresholds: bool = False):
    """``indoor_casmtr_4c_runnable`` at tiny widths: ResNetFPN_8_4_2 (RGB)
    8 / [8, 12, 16], a self and a cross quadtree layer of d 16, 2 heads,
    topks 4; the 1/4 stack of the recipe (POLA self, relative-PE cross,
    sr_ratio 2) at d 12, 2 heads, windows of 3; fine d 8, 2 heads.
    ``zero_thresholds`` lets every match through."""
    loftr = {
        "train_size": train_size,
        "backbone": {"initial_dim": 8, "block_dims": [8, 12, 16]},
        "coarse": {"d_model": 16, "nhead": 2, "topks": [4, 4, 4],
                   "layer_names": ["self", "cross"]},
        "coarse2": {"d_model": 12, "nhead": 2, "window_size": 3,
                    "attn_window_size": 3},
        "fine": {"d_model": 8, "nhead": 2},
        "match_coarse": {"max_matches": 16},
        "match_cascade": {"train_pad_num_gt_min": [16], "max_matches": [32]},
    }
    if zero_thresholds:
        loftr["match_coarse"]["thr"] = 0.0
        loftr["match_cascade"].update(test_thr=[0.0], pre_thr=[[0.0, 0.0]])
    return {"loftr": loftr}


# the model zoo's three configurations at tiny widths: a published recipe
# plus two orthogonal switches each (the tiny counterparts of chip_smoke's
# ZOO models)
ZOO = {
    "Z1": ("outdoor_casmtr_4c",
           {"coarse2": {"self_attn_type": "local_global",
                        "propagation": "dilated1", "dilated": 2}}),
    "Z2": ("outdoor_casmtr_4c",
           {"coarse2": {"self_attn_type": "LKA"},
            "coarse": {"relative_pe": True}}),
    "Z3": ("outdoor_casmtr_2c",
           {"coarse2": {"self_attn_type": "topk", "topks": [4]},
            "coarse3": {"self_attn_type": "linear"}}),
}


def tiny_zoo_overrides(name: str, train_size: int = 128,
                       zero_thresholds: bool = False):
    """(recipe, overrides) of ZOO[name] on the tiny 4c or 2c configuration
    (``tiny_4c_overrides``, ``tiny_2c_overrides``); Z3's guide takes the
    top 4 of the tiny 1/8 grid."""
    recipe, switches = ZOO[name]
    tiny = (tiny_2c_overrides if recipe.endswith("2c")
            else tiny_4c_overrides)
    ov = tiny(train_size, zero_thresholds)
    for part, value in switches.items():
        ov["loftr"][part].update(value)
    return recipe, ov


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


def flax_like(init):
    """The zero-filled float32 numpy tree of the flax variables that
    ``init()`` makes, its shapes from ``jax.eval_shape`` (traced, not
    compiled)."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  dict(jax.eval_shape(init)))


def port_variables(module, init, seed: int = 0):
    """Jittered flax variables for the same weights in both packages,
    without compiling the flax init: the port's seeded initialization of
    ``module`` (``weights.init_random_``) laid out as the tree of
    ``flax_like(init)`` (``weights.jax_variables``), then ``jitter``."""
    import torch

    from casmtr_tpu_torch.weights import init_random_, jax_variables
    init_random_(module, torch.Generator().manual_seed(seed))
    return jitter(jax_variables(module.state_dict(), flax_like(init)),
                  seed=seed)


@contextlib.contextmanager
def two_pass_batch_norm():
    """Flax's BatchNorm with the two-pass batch variance E[(x - E[x])^2],
    the port's, inside the block (flax's default is the one-pass
    E[x^2] - E[x]^2, ``use_fast_variance``).  In float32 the one-pass form
    cancels where a channel's mean dwarfs its spread: in the tiny gray
    quadtree_baseline step it puts the JAX package's backbone gradients
    2.6e-3 (relative) off their float64 value, against 2e-5 with two
    passes.  The JAX package's files stay as they are; the class is
    swapped in ``flax.linen`` for the block, so trace inside it."""
    import flax.linen as fnn

    base = fnn.BatchNorm

    class TwoPassBatchNorm(base):
        use_fast_variance: bool = False

    fnn.BatchNorm = TwoPassBatchNorm
    try:
        yield
    finally:
        fnn.BatchNorm = base


def flax_to_torch_sd(tree, shapes, prefix="matcher."):
    """A reference-format state dict (torch tensors under the reference's
    names, with its ``matcher.`` prefix) whose conversion by the JAX
    package's ``utils/convert.convert_state_dict`` reproduces the flax
    ``tree`` (``params`` or ``batch_stats``) bit-exactly: the inverse of
    its ``_transform`` (conv HWIO -> OIHW, Dense [in, out] -> [out, in]),
    as ``tests/test_cli_convert_roundtrip._flax_to_torch_sd``.  ``shapes``
    maps each unprefixed key to the reference's shape (the port's
    ``state_dict`` keeps the reference's layouts): a Dense that realizes a
    1x1 conv comes out as the reference's [out, in, 1, 1]."""
    import torch

    from casmtr_tpu.utils.convert import flax_path_to_torch_key
    sd = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            key = flax_path_to_torch_key(path, k)
            a = np.asarray(v)
            if k == "kernel" and a.ndim == 4:      # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif k == "kernel" and a.ndim == 2:    # [in,out] -> [out,in]
                a = a.T.reshape(shapes[key])       # (a 1x1 conv: [o,i,1,1])
            sd[prefix + key] = torch.from_numpy(np.ascontiguousarray(a))

    walk(tree, ())
    return sd


# the test-time filters of the filter tests at tiny size (chip_smoke's F1-F6
# at full size): F6's gates are looser than chip_smoke's rt 0.8 / rd 0.05,
# which on a tiny random model's 16^2 coarse grid keep almost nothing
FILTERS = {
    "F1": {"method": "local_window_nms", "window_size": 4, "topk": 2},
    "F2": {"method": "softargmax_nms", "window_size": 5, "stride": 1},
    "F3": {"method": "softargmax_nms", "window_size": 4, "stride": 4},
    "F4": {"method": "d2d", "window_size": 5},
    "F5": {"method": "sift"},
    "F6": {"method": "maxpool_nms", "window_size": 5, "rt": 0.97,
           "rd": 0.7},
}

# compile options of fast_jit: XLA's CPU backend without its expensive
# LLVM passes, which take most of a tiny model's compile time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


_JIT = jax.jit


def fast_jit(fn, **kw):
    """``jax.jit`` compiling with FAST_COMPILE (it may stand in for
    ``jax.jit`` itself)."""
    return _JIT(fn, compiler_options=FAST_COMPILE, **kw)


def jax_eval(module, variables, batch):
    """The flax ``module``'s eval forward on ``batch`` (fast_jit)."""
    return fast_jit(lambda v, b: module.apply(v, b, train=False))(
        variables, batch)
