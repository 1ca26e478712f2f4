"""The rest of the model zoo in the port against the JAX package, on the CPU
at tiny widths (tests/torch_parity.py ``ZOO``, ``tiny_zoo_overrides``):

* Z1: CasMTR-4c with ``local_global`` self layers (DoubleGroupBlock, its
  global half with sr_ratio 4) and the ``dilated1`` propagation at
  dilation 2 (the cascade gather paths, the upsampled full window);
* Z2: CasMTR-4c with ``LKA`` self layers (LKABlock) and the 1/8 stack's
  relative PE;
* Z3: CasMTR-2c with ``topk`` self layers at 1/4 (Guided quadtree
  attention on the 1/8 cycle top-k, one level) and ``linear`` self layers
  at 1/2.

Per module, with the same inputs (and the same jittered weights):
``window_warp_idx`` with its full window and ``upsample_idx`` (exact
integers, windows clamped at all four borders),
``relative_position_bucket`` (exact, across 0, the exact-bucket limit and
``max_distance``), the 1/8 relative PE against ``_rel_pos_2d`` (exact),
``qtatt_b`` with a relative bias at 3 levels, ``cascade_qtatt_b`` and
``window_softmax_matching`` on their gather paths, ``DoubleGroupBlock``,
``LKABlock`` in eval and in train mode (outputs and batch statistics), the
``linear`` self layer, ``_cycle_topk`` (as sets, independent of tie
order), ``qtatt_guided`` at one level with guide blocks at the grid's
edges (outputs within 1e-5, gradients within 1e-5 of the largest
gradient); the configurations that neither package runs (``topk`` with
two levels, Guided in the 1/8 stack) raise in both.

Per configuration: the weights go through a reference-format state dict
(``torch_parity.flax_to_torch_sd``) into both packages strictly, the JAX
package's conversion giving back every leaf bit-exactly and the port's
``weights.jax_variables`` likewise; the eval forward with every threshold
at 0 (same valid (b, i, j) sets at every stage and at the end, keypoints
within 1e-3 px, confidences within 1e-4); one training step against the
JAX package's step and the gradients it takes (loss terms within 1e-5
relative, per-leaf gradients within 1e-4 relative, BatchNorm statistics
within 1e-5, flax's BatchNorm in the port's two-pass variance), with
nonzero gradients on the new modules' parameters.

Each configuration's JAX model is traced once for its variables, once
for its eval forward and once for its step (``zoo``, module scope).  The
tolerances are those of test_torch_indoor.py, fixed before the first
run."""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_quadtree_loftr import grad_errors  # noqa: E402
from tests.test_torch_slice import (_assert_same_matches, _fields,  # noqa
                                    _images)
from tests.test_torch_train import _leaves as leaves  # noqa: E402
from tests.test_torch_train import (_pair_batch, jax_step,  # noqa: E402
                                    step_variables, torch_step)
from tests.torch_parity import (ZOO, configs, flax_to_torch_sd,  # noqa
                                port_variables, tiny_4c_overrides,
                                tiny_zoo_overrides, two_pass_batch_norm)

ATOL = 1e-5
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
SIZE = 64
EVAL_HW = (64, 96)
# the leaves of each configuration's new modules
NEW_LEAVES = {
    "Z1": ("block_local", "block_global"),
    "Z2": ("spatial_gating_unit", "layer_scale_1", "mlp_dwconv_dwconv",
           "w_pos_bias_0", "h_pos_bias_2"),
    "Z3": ("py_att_weight", "mlp_0"),
}
# parameters of the new modules whose gradients must be nonzero
NEW_GRADS = {
    "Z1": ("['loftr_coarse_4c']['layers_1']['block_global']['attn']['sr']"
           "['kernel']",
           "['loftr_coarse_4c']['layers_1']['block_local']['attn']['qkv']"
           "['kernel']"),
    "Z2": ("['loftr_coarse_4c']['layers_1']['attn']['spatial_gating_unit']"
           "['conv_spatial']['kernel']",
           "['loftr_coarse_4c']['layers_1']['attn']['spatial_gating_unit']"
           "['conv0']['kernel']",
           "['loftr_coarse_4c']['layers_1']['layer_scale_1']",
           "['loftr_coarse_8c']['w_pos_bias_0']['kernel']",
           "['loftr_coarse_8c']['h_pos_bias_2']['kernel']"),
    "Z3": tuple(f"['loftr_coarse_4c']['layers_1']['attn']['{p}']['kernel']"
                for p in ("q_proj", "k_proj", "v_proj"))
          + ("['loftr_coarse_2c']['layers_1']['q_proj']['kernel']",),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def _jax_fwd_bwd(fn, args, seed):
    """``fn(*args)`` and its VJP on a seeded unit-normal cotangent, in one
    compiled call (the JAX side of a module is far faster compiled than op
    by op); returns (output, gradients, cotangent)."""
    out = jax.eval_shape(fn, *args)
    g = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)

    def both(*a):
        y, vjp = jax.vjp(fn, *a)
        return y, vjp(jnp.asarray(g))

    y, grads = jax.jit(both)(*args)
    return y, grads, g


def _close_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        assert _max_rel(g.numpy(), w) <= ATOL, name


# --------------------------------------------------------------------------
# the dilated propagation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window_size,dilated", [(3, 2), (5, 2), (5, 3)])
def test_dilated_windows_and_upsample_idx_match_jax(window_size, dilated):
    """On a 9x13 half grid whose every border cell is a match, besides
    random ones: the window, the full window and their upsampling (at
    dilation 3 the window is 13 wide, wider than the grid's 9 rows)."""
    from casmtr_tpu.models.cascade_transformer import \
        upsample_idx as jax_upsample
    from casmtr_tpu.models.cascade_transformer import \
        window_warp_idx as jax_warp
    from casmtr_tpu.ops.propagation import get_propagations as jax_props
    from casmtr_tpu_torch.models.cascade_transformer import (upsample_idx,
                                                             window_warp_idx)
    from casmtr_tpu_torch.ops.propagation import get_propagations
    h, w = 9, 13
    window, full = get_propagations("dilated1", window_size, dilated)
    jwin, jfull = jax_props("dilated1", window_size, dilated)
    np.testing.assert_array_equal(window, jwin)
    np.testing.assert_array_equal(full, jfull)
    grid = np.arange(h * w).reshape(h, w)
    border = np.concatenate([grid[0], grid[-1], grid[:, 0], grid[:, -1]])
    rng = np.random.default_rng(window_size * dilated)
    idx = np.stack([np.concatenate([border, rng.integers(0, h * w, 40)]),
                    rng.integers(0, h * w, len(border) + 40)])
    want_w, want_f = jax_warp(jnp.asarray(idx, jnp.int32), window, h, w,
                              full)
    got_w, got_f = window_warp_idx(_t(idx), window, h, w, full)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    if 2 * (window_size // 2) * dilated < h:   # the window fits the grid:
        assert got_f.min() == 0 and got_f[..., 0].max() == h - 1
        assert got_f[..., 1].max() == w - 1
    np.testing.assert_array_equal(
        window_warp_idx(_t(idx), window, h, w).numpy(), np.asarray(want_w))
    # image0's half grid of P = 2 x 66 parents onto image1's 9x13 one
    pos = got_f.reshape(1, 2 * idx.shape[1], -1, 2)
    want_u = jax_upsample(jnp.asarray(pos.numpy()), 2, h, w)
    got_u = upsample_idx(pos, 2, h, w)
    assert got_u.shape == (1, 4 * pos.shape[1], 4 * full.shape[0])
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


# --------------------------------------------------------------------------
# the 1/8 stack's relative PE
# --------------------------------------------------------------------------

def test_relative_position_bucket_matches_jax():
    from casmtr_tpu.models.transformer import relative_position_bucket as jrb
    from casmtr_tpu_torch.models.transformer import relative_position_bucket
    rel = np.arange(-300, 301)
    for nb in (1, 2, 4, 8, 11, 22, 44, 88, 104, 176):
        for md in (1, 3, 8, 13, 26, 52, 104, 300):
            want = np.asarray(jrb(jnp.asarray(rel), nb, md))
            got = relative_position_bucket(_t(rel), nb, md).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{nb} {md}")


def _jax_rel_pos(train_size, hw, nhead, seed=0):
    """The JAX package's dense per-level biases [1, H, L, L] (coarsest
    first) and their flax variables, through ``_rel_pos_2d`` itself."""
    import flax.linen as fnn

    from casmtr_tpu.models.transformer import LocalFeatureTransformer

    class Levels(fnn.Module):
        train_size: int

        @fnn.compact
        def __call__(self):
            return [LocalFeatureTransformer._rel_pos_2d(self, *hw, i, nhead)
                    for i in (2, 1, 0)]

    m = Levels(train_size)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        dict(jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))))
    return jax.jit(m.apply)(variables), variables["params"]


def _port_rel_pos(params, hw):
    """The port's biases on the same tables, coarsest first."""
    from casmtr_tpu_torch.models.transformer import RelativePositionBias
    h, w = hw
    return [RelativePositionBias(
        _t(params[f"w_pos_bias_{i}"]["kernel"].T),
        _t(params[f"h_pos_bias_{i}"]["kernel"].T),
        (h // 2 ** i, w // 2 ** i)) for i in (2, 1, 0)]


def test_relative_pe_matches_rel_pos_2d():
    hw, H = (8, 12), 3
    want, params = _jax_rel_pos(16, hw, H)
    for i, (rel, w) in enumerate(zip(_port_rel_pos(params, hw), want)):
        L = rel.hw[0] * rel.hw[1]
        got = rel(torch.arange(L)[:, None, None], torch.arange(L)[None, :,
                                                                   None])
        assert got.shape == (L, L, H)
        np.testing.assert_array_equal(got.permute(2, 0, 1)[None].numpy(),
                                      np.asarray(w), err_msg=f"level {i}")


def test_qtatt_b_with_relative_bias_matches_jax():
    """Three levels (8x12, 4x6, 2x3), top 4 at each, the dense JAX biases
    against the port's lookups; gradients of q, k and v at every level."""
    from casmtr_tpu.ops.quadtree import qtatt_b as jax_qtatt_b
    from casmtr_tpu_torch.ops.quadtree import qtatt_b
    hw, H, D, topks = (8, 12), 2, 8, (4, 4, 4)
    sizes = [(hw[0] >> i, hw[1] >> i) for i in range(3)]
    dense, params = _jax_rel_pos(16, hw, H, seed=1)
    rng = np.random.default_rng(2)
    qkv = [[rng.standard_normal((2, h * w, H, D)).astype(np.float32)
            for h, w in sizes] for _ in range(3)]
    weight = rng.standard_normal(3).astype(np.float32)

    def jax_fn(qs, ks, vs):
        return jax_qtatt_b(qs, ks, vs, sizes, topks, jnp.asarray(weight),
                           rel_pos=dense)

    want, want_g, g = _jax_fwd_bwd(jax_fn, [[jnp.asarray(x) for x in t]
                                            for t in qkv], 3)
    ts = [[_t(x).requires_grad_(True) for x in t] for t in qkv]
    got = qtatt_b(*ts, sizes, topks, _t(weight),
                  rel_pos=_port_rel_pos(params, hw))
    assert _max_rel(got.detach().numpy(), want) <= ATOL
    got.backward(_t(g))
    for name, wl, tl in zip("qkv", want_g, ts):
        _close_grads([t.grad for t in tl], wl,
                     [f"d{name} level {i}" for i in range(3)])


# --------------------------------------------------------------------------
# the cascade gather paths
# --------------------------------------------------------------------------

def _dilated_case(seed, hw_q=(16, 24), hw_k=(16, 20), window_size=3,
                  dilated=2):
    """Dilated windows of image0's parents on image1's half grid."""
    from casmtr_tpu_torch.models.cascade_transformer import window_warp_idx
    from casmtr_tpu_torch.ops.propagation import get_propagations
    window, full = get_propagations("dilated1", window_size, dilated)
    rng = np.random.default_rng(seed)
    P = (hw_q[0] // 2) * (hw_q[1] // 2)
    h2, w2 = hw_k[0] // 2, hw_k[1] // 2
    nxt = rng.integers(0, h2 * w2, (1, P))
    nxt[0, :4] = (0, w2 - 1, (h2 - 1) * w2, h2 * w2 - 1)
    return window_warp_idx(_t(nxt), window, h2, w2, full), rng


def test_cascade_gather_path_matches_jax():
    """``cascade_qtatt_b`` on dilated windows (children 2 apart), with no
    bias: message, upsampled indices and q/k/v gradients."""
    from casmtr_tpu.ops.quadtree import cascade_qtatt_b as jax_fn
    from casmtr_tpu_torch.ops.quadtree import cascade_qtatt_b
    hw_q, hw_k, H, D = (16, 24), (16, 20), 2, 8
    (win, _), rng = _dilated_case(0, hw_q, hw_k)
    qkv = [rng.standard_normal((1, h * w, H, D)).astype(np.float32)
           for h, w in (hw_q, hw_k, hw_k)]
    jwin = jnp.asarray(win.numpy())
    want, want_g, g = _jax_fwd_bwd(lambda q, k, v: jax_fn(
        q, k, v, jwin, hw_q, hw_k, dilated=2)[0], list(map(jnp.asarray, qkv)),
        4)
    want_idx = jax_fn(*map(jnp.asarray, qkv), jwin, hw_q, hw_k,
                      dilated=2)[1]
    ts = [_t(x).requires_grad_(True) for x in qkv]
    got, got_idx = cascade_qtatt_b(*ts, win, hw_q, hw_k, dilated=2)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert _max_rel(got.detach().numpy(), want) <= ATOL
    got.backward(_t(g))
    _close_grads([t.grad for t in ts], want_g, "qkv")


@pytest.mark.parametrize("masked", [False, True], ids=["", "masked"])
def test_window_softmax_matching_gather_path_matches_jax(masked,
                                                         monkeypatch):
    """On the upsampled full windows in both directions, the gathered
    scores taken a few candidates at a time (and recomputed for the
    backward), with and without padding masks: every output, and the
    gradients of the 0->1 confidences."""
    from casmtr_tpu.models.cascade_transformer import \
        upsample_idx as jax_upsample
    from casmtr_tpu.ops.cascade_matching import \
        window_softmax_matching as jax_fn
    from casmtr_tpu_torch.ops import cascade_matching as cm
    hw, C = (16, 20), 12
    (_, full01), rng = _dilated_case(1, hw, hw)
    (_, full10), _ = _dilated_case(2, hw, hw)
    idx = [np.asarray(jax_upsample(jnp.asarray(f.numpy()), hw[0] // 2,
                                   hw[0] // 2, hw[1] // 2))
           for f in (full01, full10)]
    L = hw[0] * hw[1]
    f0, f1 = (rng.standard_normal((1, L, C)).astype(np.float32)
              for _ in range(2))
    masks = [None, None]
    if masked:
        masks = [np.ones((1, L), bool) for _ in range(2)]
        masks[0][0, -3 * hw[1]:] = False
        masks[1].reshape(1, *hw)[0, :, -4:] = False

    def jax_run(a, b):
        return jax_fn(a, b, *map(jnp.asarray, idx), 0.5,
                      *[None if m is None else jnp.asarray(m) for m in masks])

    want_r = jax.jit(jax_run)(jnp.asarray(f0), jnp.asarray(f1))
    _, want_g, g = _jax_fwd_bwd(lambda a, b: jax_run(a, b).conf01,
                                [jnp.asarray(f0), jnp.asarray(f1)], 5)
    monkeypatch.setattr(cm, "SCORE_CHUNK_BYTES", L * C * 4 * 7)
    ts = [_t(x).requires_grad_(True) for x in (f0, f1)]
    got = cm.window_softmax_matching(
        *ts, *map(_t, idx), 0.5,
        *[None if m is None else _t(m) for m in masks])
    for name in ("conf01", "conf10", "next_conf_c01", "next_conf_c10",
                 "max_sim_c01"):
        assert _max_rel(getattr(got, name).detach().numpy(),
                        getattr(want_r, name)) <= ATOL, name
    for name in ("next_idx_c01", "next_idx_c10"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want_r, name)))
    (got.conf01 * _t(g)).sum().backward()
    _close_grads([t.grad for t in ts], want_g, ("feat0", "feat1"))


# --------------------------------------------------------------------------
# the self layers
# --------------------------------------------------------------------------

def _block_pair(jax_block, port_block, x, *args, **kw):
    """The flax block on jittered port weights and the port block loaded
    with them; returns the flax variables."""
    from casmtr_tpu_torch.weights import load_jax_variables
    variables = port_variables(port_block, lambda: jax_block.init(
        jax.random.PRNGKey(0), jnp.asarray(x), *args, **kw))
    load_jax_variables(port_block, variables)
    return variables


def test_double_group_block_matches_flax():
    """A 10x13 map: the local windows of 3 padded, the global block's
    4x4 stride-4 reduction flooring the grid (2x3 keys)."""
    from casmtr_tpu.models.cascade_attention import DoubleGroupBlock as JB
    from casmtr_tpu_torch.models.cascade_attention import DoubleGroupBlock
    h, w, C = 10, 13, 12
    x = np.random.default_rng(0).standard_normal((2, h * w, C)).astype(
        np.float32)
    jb, tb = JB(C, 2, 4.0, 4, 3), DoubleGroupBlock(C, 2, 4.0, 4, 3)
    variables = _block_pair(jb, tb, x, h, w)
    assert "sr" in variables["params"]["block_global"]["attn"]
    want = jax.jit(jb.apply, static_argnums=(2, 3))(variables,
                                                    jnp.asarray(x), h, w)
    with torch.no_grad():
        got = tb(_t(x), h, w)
    assert _max_rel(got.numpy(), want) <= ATOL


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lka_block_matches_flax(train):
    """On a 9x14 map; in train mode with batch statistics, which both
    packages move alike (flax's BatchNorm in the two-pass variance)."""
    from casmtr_tpu.models.cascade_attention import LKABlock as JB
    from casmtr_tpu_torch.models.cascade_attention import LKABlock
    from casmtr_tpu_torch.weights import jax_variables
    h, w, C = 9, 14, 8
    x = (np.random.default_rng(1).standard_normal((2, h * w, C)) + 0.5
         ).astype(np.float32)
    jb, tb = JB(C, 4.0), LKABlock(C, 4.0)
    variables = _block_pair(jb, tb, x, h, w)
    tb.train(train)
    inputs = (x,) if train else (x, x.astype(jnp.bfloat16))
    for xi in inputs:      # a bf16 input computes in float32 on its values
        with two_pass_batch_norm():
            want, stats = jax.jit(functools.partial(
                jb.apply, h=h, w=w, train=train, mutable=["batch_stats"]))(
                    variables, jnp.asarray(xi))
        with torch.no_grad():
            got = tb(_t(x).to(torch.bfloat16 if xi.dtype != np.float32
                              else torch.float32), h, w)
        assert got.dtype == torch.float32
        assert _max_rel(got.numpy(), want) <= ATOL, xi.dtype
    got_stats = leaves(jax_variables(
        tb.state_dict(), {"batch_stats": variables["batch_stats"]})[
            "batch_stats"])
    start = leaves(variables["batch_stats"])
    for k, v in leaves(stats["batch_stats"]).items():
        np.testing.assert_allclose(got_stats[k], v, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert (not np.array_equal(v, start[k])) == train, k


def test_linear_self_layer_matches_flax():
    from casmtr_tpu.models.transformer import LoFTREncoderLayer as JL
    from casmtr_tpu_torch.models.transformer import LoFTREncoderLayer
    x = np.random.default_rng(2).standard_normal((2, 40, 12)).astype(
        np.float32)
    jl, tl = JL(12, 2, "linear"), LoFTREncoderLayer(12, 2, "linear")
    variables = _block_pair(jl, tl, x, jnp.asarray(x))
    want = jax.jit(jl.apply)(variables, jnp.asarray(x), jnp.asarray(x))
    with torch.no_grad():
        got = tl(_t(x), _t(x))
    assert _max_rel(got.numpy(), want) <= ATOL


# --------------------------------------------------------------------------
# topk: the cycle top-k and Guided quadtree attention
# --------------------------------------------------------------------------

def test_cycle_topk_matches_jax():
    """A softmax confidence matrix 6x8 -> 5x7 with rows of exact ties (all
    zero, as padded cells give): the same guide sets per row."""
    from casmtr_tpu.models.cascade_transformer import \
        CascadeFeatureTransformer as JaxCFT
    from casmtr_tpu_torch.models.cascade_transformer import \
        CascadeFeatureTransformer
    jcfg, tcfg = configs(tiny_zoo_overrides("Z3")[1], ZOO["Z3"][0])
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 48, 35)).astype(np.float32) * 3
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    conf[0, 40:] = 0.0
    conf[1, :, 30:] = 0.0
    want = JaxCFT._cycle_topk(types.SimpleNamespace(config=jcfg.loftr.coarse2),
                              jnp.asarray(conf), (6, 8), (5, 7))
    got = CascadeFeatureTransformer(tcfg.loftr.coarse2)._cycle_topk(_t(conf))
    k, nh = tcfg.loftr.coarse2.topks[0], tcfg.loftr.coarse2.nhead
    for g, w, rows in zip(got, want, (48, 35)):
        assert g.shape == (2, rows, k, nh) and g.dtype == torch.int32
        np.testing.assert_array_equal(np.sort(g.numpy(), axis=2),
                                      np.sort(np.asarray(w), axis=2))


def test_qtatt_guided_matches_jax():
    """One 8x12 level, 6 guide blocks per parent and head, distinct, each
    parent's row holding the corner and edge blocks of the 4x6 parent
    grid; the message and the q/k/v and merge-logit gradients."""
    from casmtr_tpu.ops.quadtree import qtatt_guided as jax_fn
    from casmtr_tpu_torch.ops.quadtree import qtatt_guided
    hw, H, D, K = (8, 12), 2, 8, 6
    rng = np.random.default_rng(4)
    P = (hw[0] // 2) * (hw[1] // 2)
    edges = np.array([0, 5, 18, 23, 2, 12])        # corners, top, left
    guide = np.stack([np.stack([np.stack(
        [rng.permutation(edges) if p % 3 == 0 else
         rng.choice(P, K, replace=False) for _ in range(H)], -1)
        for p in range(P)]) for _ in range(2)]).astype(np.int32)
    qkv = [rng.standard_normal((2, hw[0] * hw[1], H, D)).astype(np.float32)
           for _ in range(3)]
    weight = rng.standard_normal(1).astype(np.float32)
    want, want_g, g = _jax_fwd_bwd(lambda q, k, v, wt: jax_fn(
        [q], [k], [v], [hw], [K], wt, jnp.asarray(guide)),
        list(map(jnp.asarray, qkv + [weight])), 6)
    ts = [_t(x).requires_grad_(True) for x in qkv + [weight]]
    got = qtatt_guided([ts[0]], [ts[1]], [ts[2]], [hw], ts[3], _t(guide))
    assert _max_rel(got.detach().numpy(), want) <= ATOL
    got.backward(_t(g))
    _close_grads([t.grad for t in ts[:3]], want_g[:3], "qkv")
    # softmax of one logit: its gradient is 0 in both
    assert float(ts[3].grad.abs().max()) == 0.0
    assert float(np.abs(np.asarray(want_g[3])).max()) == 0.0


def test_configurations_neither_package_runs_raise_in_both():
    """``topk`` with two levels: the JAX stack's einsum fails on the guide
    (its rows are the 1/8 cells, the level's parents are 4x as many), the
    port refuses before any work; Guided in the 1/8 stack: the JAX stack
    has no guide to read, the port refuses at construction."""
    from casmtr_tpu.models.cascade_transformer import \
        CascadeFeatureTransformer as JaxCFT
    from casmtr_tpu.models.transformer import \
        LocalFeatureTransformer as JaxLFT
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.models.cascade_transformer import \
        CascadeFeatureTransformer
    from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
    recipe, ov = tiny_zoo_overrides("Z3")
    ov["loftr"]["coarse2"]["topks"] = [4, 4]
    jcfg, tcfg = configs(ov, recipe)
    t4 = jnp.zeros((1, 256, 12), jnp.float32)
    idx = jnp.zeros((1, 64), jnp.int32)
    conf = jnp.full((1, 64, 64), 1 / 64, jnp.float32)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda: JaxCFT(jcfg.loftr.coarse2, 32).init(
            jax.random.PRNGKey(0), t4, t4, idx, idx, (16, 16), (16, 16),
            (8, 8), (8, 8), idx, idx, conf))
    for build in (lambda: build_model(tcfg.loftr),
                  lambda: CascadeFeatureTransformer(tcfg.loftr.coarse2)):
        with pytest.raises(ValueError, match="one pyramid level"):
            build()

    ov = tiny_4c_overrides()
    ov["loftr"]["coarse"]["attn_type"] = "Guided"
    jcfg, tcfg = configs(ov)
    t8 = jnp.zeros((1, 64, 16), jnp.float32)
    with pytest.raises(Exception):
        jax.eval_shape(lambda: JaxLFT(jcfg.loftr.coarse, 16).init(
            jax.random.PRNGKey(0), t8, t8, (8, 8), (8, 8)))
    with pytest.raises(ValueError, match="passes none"):
        LocalFeatureTransformer(tcfg.loftr.coarse, 16)


# --------------------------------------------------------------------------
# the three configurations: weights, eval forward, training step
# --------------------------------------------------------------------------

def _no_double_check(ov):
    """The cascade double checks off, so that the random model keeps many
    matches at every level (as test_torch_2c.py's step)."""
    n = len(ov["loftr"].get("cascade_levels", [4]))
    ov["loftr"]["match_cascade"]["double_check"] = [False] * n
    return ov


@pytest.fixture(scope="module", params=sorted(ZOO))
def zoo(request):
    """Per configuration: jittered variables from the port's seeded
    initialization (the tree from the flax init's shapes), written as a
    reference-format state dict and loaded strictly by both packages'
    conversions; the eval forward of both (thresholds at 0) on a 64x96
    pair; one training step of each at 64^2."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu.utils.convert import convert_state_dict as jax_convert
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.utils.convert import convert_state_dict
    from casmtr_tpu_torch.weights import jax_variables
    name = request.param
    recipe, ov = tiny_zoo_overrides(name, SIZE)
    jcfg, tcfg = configs(_no_double_check(ov), recipe)
    batch = _pair_batch(size=SIZE)
    jm, like, variables = step_variables(jcfg, tcfg, batch)

    # the weights through a reference-format state dict, both ways
    recipe, ov = tiny_zoo_overrides(name, SIZE, zero_thresholds=True)
    jcfg_e, tcfg_e = configs(_no_double_check(ov), recipe)
    model = CasMTR(tcfg_e.loftr)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = flax_to_torch_sd(variables["params"], shapes)
    sd.update(flax_to_torch_sd(variables["batch_stats"], shapes))
    jvars, jreport = jax_convert(sd, like, strict=True)
    report = convert_state_dict(sd, model, strict=True)
    back = jax_variables(model.state_dict(), like)

    img0, img1 = _images(np.random.default_rng(5), 1, *EVAL_HW)
    jb = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm_e = JaxCasMTR(jcfg_e.loftr)
    want = jax.jit(lambda v, b: jm_e.apply(v, b, train=False))(jvars, jb)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": _t(img0), "image1": _t(img1)})

    jstep = jax_step(jm, jcfg, variables, batch, two_pass_bn=True)
    tstep = torch_step(tcfg, variables, like, batch)
    return dict(name=name, variables=variables, jvars=jvars, back=back,
                reports=(jreport, report), want=want, got=got, jstep=jstep,
                tstep=tstep)


def test_zoo_weights_load_strictly_both_ways(zoo):
    jreport, report = zoo["reports"]
    assert jreport == {"missing": [], "unused": []}
    assert report == {"missing": [], "unused": []}
    want = leaves(zoo["variables"])
    for k in NEW_LEAVES[zoo["name"]]:
        assert any(k in key for key in want), k
    for tree in (zoo["jvars"], zoo["back"]):
        got = leaves(tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_zoo_eval_forward_matches_jax(zoo):
    got, want = zoo["got"], zoo["want"]
    _assert_same_matches(_fields(got.coarse.matches),
                         _fields(want.coarse.matches))
    assert set(got.cascades) == set(want.cascades)
    for lvl, g in got.cascades.items():
        w = want.cascades[lvl]
        np.testing.assert_array_equal(g.idx_c01.numpy(),
                                      np.asarray(w.idx_c01))
        np.testing.assert_allclose(g.conf_matrix.numpy(),
                                   np.asarray(w.conf_matrix), rtol=0,
                                   atol=CONF_ATOL, err_msg=lvl)
        _assert_same_matches(_fields(g.matches), _fields(w.matches))
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    _assert_same_matches(got_f, want_f)


def test_zoo_train_step_loss_matches_jax(zoo):
    js, ts = zoo["jstep"][0], zoo["tstep"][0]
    assert set(ts) == set(js)
    for k in js:
        if k.startswith("valid_n"):
            assert int(ts[k]) == int(js[k]) > 0, k
        else:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=STEP_LOSS_RTOL, err_msg=k)


def test_zoo_train_step_gradients_match_jax(zoo):
    want, got = leaves(zoo["jstep"][1]), leaves(zoo["tstep"][1])
    assert got.keys() == want.keys()
    for k, err in grad_errors(got, want).items():
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_RTOL, f"{k}: relative error {err}"
    for k in NEW_GRADS[zoo["name"]]:
        assert np.abs(got[k]).max() > 0 and np.abs(want[k]).max() > 0, k


def test_zoo_train_step_batch_stats_match_jax(zoo):
    want, got = leaves(zoo["jstep"][2]), leaves(zoo["tstep"][2])
    start = leaves(zoo["variables"]["batch_stats"])
    assert got.keys() == want.keys()
    if zoo["name"] == "Z2":
        assert sum("loftr_coarse_4c" in k for k in want) == 4
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"
