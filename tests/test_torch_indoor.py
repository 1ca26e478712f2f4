"""The indoor recipe ``indoor_casmtr_4c_runnable`` in the port against the
JAX package, on the CPU at tiny widths (tests/torch_parity.py
``tiny_indoor_overrides``: ResNetFPN_8_4_2 in RGB, the recipe's 1/4 stack
of POLA self layers and relative-PE cross layers at d 12), with the same
jittered weights:

* ``pola_relative_position_index`` equal to the JAX one;
* ``POLATransBlock`` against the flax block on a map whose sides are not
  multiples of the window (padded, and its border keys unmasked): within
  1e-5;
* the windowed relative PE (``_relative_pe``) against the JAX one on two
  images of different, non-square grids: exactly equal;
* ``cascade_qtatt_b`` with a relative bias (the gather path) and its
  q/k/v/bias gradients against ``jax.vjp``: within 1e-5 (gradients of the
  largest gradient);
* the eval forward with every threshold at 0 and the 1/4 double check
  off (so every stage keeps many matches), at a square and a non-square
  input: the same valid (b, i, j) sets at the 1/8 and 1/4 stages and at
  the end, keypoints within 1e-3 px, confidences and the 1/4 window
  confidences within 1e-4;
* ``Matcher("indoor_casmtr_4c_runnable")`` against the JAX ``Matcher`` on
  a square and a padded request;
* one training step against the JAX package's step and ``jax.grad`` of the
  same composition (flax's BatchNorm in the port's two-pass variance, as
  test_torch_quadtree_loftr.py): loss terms within 1e-5 relative,
  per-leaf gradients within 1e-4 relative, BatchNorm statistics within
  1e-5;
* the branches refused here until they were ported now build: the
  detector head and the detector modes (tests/test_torch_detector.py
  holds them against the JAX package), the ``local_global``, ``topk``,
  ``linear`` and ``LKA`` self layers and the 1/8 relative PE
  (tests/test_torch_zoo.py); quadtree attention ``Guided`` in the 1/8
  stack, which the JAX package cannot run, raises ValueError.

The tolerances were fixed before the first run."""

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
from tests.torch_parity import (configs, jitter,  # noqa: E402
                                port_variables, tiny_indoor_overrides)

RECIPE = "indoor_casmtr_4c_runnable"
ATOL = 1e-5
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
TRAIN_SIZE = 64


# --------------------------------------------------------------------------
# POLA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [3, 5, 7])
def test_pola_relative_position_index_matches_jax(ws):
    from casmtr_tpu.models.pola import pola_relative_position_index as want
    from casmtr_tpu_torch.models.pola import pola_relative_position_index
    got = pola_relative_position_index(ws)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want(ws))


@pytest.mark.parametrize("hw,ws", [((10, 13), 3), ((11, 9), 7)])
def test_pola_block_matches_flax(hw, ws):
    from casmtr_tpu.models.pola import POLATransBlock as JaxBlock
    from casmtr_tpu_torch.models.pola import POLATransBlock
    from casmtr_tpu_torch.weights import load_jax_variables
    h, w = hw
    x = np.random.default_rng(0).standard_normal((2, h * w, 12)).astype(
        np.float32)
    jb = JaxBlock(12, 2, window_size=ws)
    variables = jitter(jb.init(jax.random.PRNGKey(0), jnp.asarray(x), h, w))
    want = jb.apply(variables, jnp.asarray(x), h, w)
    tb = POLATransBlock(12, 2, ws)
    load_jax_variables(tb, variables)
    with torch.no_grad():
        got = tb(torch.from_numpy(x), h, w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# --------------------------------------------------------------------------
# the windowed relative PE and the relative-PE cascade attention
# --------------------------------------------------------------------------

def _stack_configs():
    jcfg, tcfg = configs(tiny_indoor_overrides(), RECIPE)
    return jcfg.loftr.coarse2, tcfg.loftr.coarse2


def test_relative_pe_matches_jax():
    """Query level 8x12 (1/8 grid 4x6), target level 10x6 (5x3): every
    (x, y) / (row, col) order and the target's width show."""
    from casmtr_tpu.models.cascade_transformer import \
        CascadeFeatureTransformer as JaxCFT
    from casmtr_tpu_torch.models.cascade_transformer import (
        CascadeFeatureTransformer, window_warp_idx)
    jc, tc = _stack_configs()
    hw_q, hw_t = (8, 12), (10, 6)
    hc_q, hc_t = (4, 6), (5, 3)
    rng = np.random.default_rng(0)
    nxt = rng.integers(0, hc_t[0] * hc_t[1], (2, hc_q[0] * hc_q[1]))
    model = CascadeFeatureTransformer(tc)
    win = window_warp_idx(torch.from_numpy(nxt), model.window, *hc_t)
    jm = JaxCFT(jc, 64)
    args = (hc_q, hc_t, jnp.asarray(nxt), jnp.asarray(win.numpy()), *hw_q)
    variables = jitter(jm.init(jax.random.PRNGKey(0), *args,
                               method=JaxCFT._relative_pe))
    want = jm.apply(variables, *args, method=JaxCFT._relative_pe)
    with torch.no_grad():
        for name in ("h_pos_bias", "w_pos_bias"):
            getattr(model, name).weight.copy_(torch.from_numpy(
                variables["params"][name]["embedding"]))
        got = model._relative_pe(hc_q, hc_t, torch.from_numpy(nxt), win,
                                 *hw_q)
    assert got.shape == want.shape == (2, tc.nhead, 96, 4 * 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cascade_qtatt_b_relative_pe_matches_jax():
    """The gather path with a bias on a 12x8 query grid against a 10x6 key
    grid (w = 3), forward and the gradients of q, k, v and the bias."""
    from casmtr_tpu.ops.quadtree import cascade_qtatt_b as jax_fn
    from casmtr_tpu_torch.models.cascade_transformer import window_warp_idx
    from casmtr_tpu_torch.ops.propagation import get_propagations
    from casmtr_tpu_torch.ops.quadtree import cascade_qtatt_b
    rng = np.random.default_rng(1)
    hw_q, hw_k, H, D, ws = (12, 8), (10, 6), 2, 4, 3
    Lq, Lk = hw_q[0] * hw_q[1], hw_k[0] * hw_k[1]
    window, _ = get_propagations("window", ws)
    nxt = rng.integers(0, Lk // 4, (1, Lq // 4))
    pos = window_warp_idx(torch.from_numpy(nxt), window, hw_k[0] // 2,
                          hw_k[1] // 2).numpy()
    q, k, v = (rng.standard_normal((1, n, H, D)).astype(np.float32)
               for n in (Lq, Lk, Lk))
    rel = rng.standard_normal((1, H, Lq, 4 * ws * ws)).astype(np.float32)

    def jf(q, k, v, rel):
        return jax_fn(q, k, v, jnp.asarray(pos), hw_q, hw_k, rel_pos=rel,
                      window_structured=True)

    (want, want_idx), vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v, rel)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, rel)]
    got, got_idx = cascade_qtatt_b(*ts[:3], torch.from_numpy(pos), hw_q,
                                   hw_k, rel_pos=ts[3],
                                   window_structured=True)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    g = rng.standard_normal(want.shape).astype(np.float32)
    want_g = vjp((jnp.asarray(g), np.zeros(want_idx.shape,
                                           jax.dtypes.float0)))
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(("q", "k", "v", "rel_pos"), ts, want_g):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(
            t.grad.numpy(), w, rtol=0,
            atol=ATOL * max(1.0, float(np.abs(w).max())), err_msg=name)


# --------------------------------------------------------------------------
# the eval forward and the Matcher
# --------------------------------------------------------------------------

def _eval_overrides():
    ov = tiny_indoor_overrides(zero_thresholds=True)
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    return ov


@pytest.mark.parametrize("hw", [(128, 128), (96, 128)],
                         ids=["square", "non-square"])
def test_indoor_eval_forward_stages_match_jax(hw):
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    jcfg, tcfg = configs(_eval_overrides(), RECIPE)
    img0, img1 = _images(np.random.default_rng(0), 2, *hw)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxCasMTR(jcfg.loftr)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    names = leaves(variables)
    assert any("relative_position_bias_table" in k for k in names)
    assert any("h_pos_bias" in k for k in names)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    _assert_same_matches(_fields(got.coarse.matches),
                         _fields(want.coarse.matches))
    _assert_same_matches(_fields(got.cascades["4c"].matches),
                         _fields(want.cascades["4c"].matches))
    np.testing.assert_allclose(got.cascades["4c"].conf_matrix.numpy(),
                               np.asarray(want.cascades["4c"].conf_matrix),
                               rtol=0, atol=CONF_ATOL)
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    assert got_f["valid"].sum() > 1
    _assert_same_matches(got_f, want_f)


def test_indoor_matcher_answers_like_jax_matcher():
    """A square request and a 128x64 one that the 128 bucket pads (masks on
    the path), through both Matchers with the same weights."""
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = _eval_overrides()
    jmatch = JaxMatcher(RECIPE, bucket=128, df=32, thr=0.0, overrides=ov)
    jmatch.variables = jitter(jmatch.variables)
    tmatch = Matcher(RECIPE, bucket=128, df=32, thr=0.0, overrides=ov,
                     device="cpu")
    load_jax_variables(tmatch.model, jmatch.variables)
    rng = np.random.default_rng(1)
    a0, a1 = _images(rng, 1, 128, 128)
    b0, b1 = _images(rng, 1, 128, 64)
    for img0, img1 in ((a0[0], a1[0]), (b0[0], b1[0])):
        want = jmatch.match(img0, img1)
        got = tmatch.match(img0, img1)
        assert len(want.mconf) > 0 and len(got.mconf) == len(want.mconf)
        og, ow = np.lexsort(got.mkpts0.T), np.lexsort(want.mkpts0.T)
        for name, atol in (("mkpts0", PX_ATOL), ("mkpts1", PX_ATOL),
                           ("mconf", CONF_ATOL)):
            np.testing.assert_allclose(getattr(got, name)[og],
                                       getattr(want, name)[ow], rtol=0,
                                       atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_run():
    """One step of each package from the same jittered variables and batch
    (the 1/4 double check off, as in test_torch_train.py, so that the
    random model keeps 1/4 matches for the cascade and fine losses).  The
    pair is the identity (image1 = image0, shift 0): on test_torch_train's
    pair shifted by 8 px the tiny random indoor model's 1/4 matches fall
    outside every fine window (loss_f 0 for weight seeds 1-3), and the
    fine stage would carry no gradient."""
    ov = tiny_indoor_overrides(train_size=TRAIN_SIZE)
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    jcfg, tcfg = configs(ov, RECIPE)
    batch = _pair_batch(size=TRAIN_SIZE, shift=0)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    return dict(zip(("jscalars", "jgrads", "jstats"),
                    jax_step(jm, jcfg, variables, batch, two_pass_bn=True)),
                **dict(zip(("tscalars", "tgrads", "tstats"),
                           torch_step(tcfg, variables, like, batch))),
                start=variables["batch_stats"])


def test_indoor_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js)
    for k in ("loss", "loss_8c", "loss_4c", "loss_f", "grad_norm"):
        print(f"{k}: relative error {abs(float(ts[k]) / float(js[k]) - 1):.2e}")
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    assert int(ts["valid_n_4c"]) == int(js["valid_n_4c"]) > 0
    assert float(ts["loss_4c"]) > 0 and float(ts["loss_f"]) > 0


def test_indoor_train_step_gradients_match_jax(step_run):
    want, got = leaves(step_run["jgrads"]), leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    for part in ("relative_position_bias_table", "h_pos_bias", "w_pos_bias",
                 "Wq"):
        assert any(part in k and np.abs(w).max() > 0
                   for k, w in want.items()), part
    for k, err in grad_errors(got, want).items():
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_RTOL, f"{k}: relative error {err}"


def test_indoor_train_step_batch_stats_match_jax(step_run):
    want, got = leaves(step_run["jstats"]), leaves(step_run["tstats"])
    start = leaves(step_run["start"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"


# --------------------------------------------------------------------------
# what is still refused
# --------------------------------------------------------------------------

REFUSED = {
    "local_global": {"coarse2": {"self_attn_type": "local_global"}},
    "topk": {"coarse2": {"self_attn_type": "topk", "topks": [4]}},
    "linear": {"coarse2": {"self_attn_type": "linear"}},
    "LKA": {"coarse2": {"self_attn_type": "LKA"}},
    "detector": {"coarse2": {"detector": "learnable"}},
    "detector_mode": {"coarse2": {"detector_mode": "gumbel"}},
    "Guided": {"coarse": {"attn_type": "Guided"}},
    "coarse relative PE": {"coarse": {"relative_pe": True}},
}


# refused until they were ported: now they build (tests/test_torch_zoo.py
# and tests/test_torch_detector.py hold them against the JAX package)
PORTED = {"detector": "detector", "detector_mode": "detector",
          "local_global": "DoubleGroupBlock", "topk": "QuadtreeBlock",
          "linear": "LoFTREncoderLayer", "LKA": "LKABlock",
          "coarse relative PE": "w_pos_bias"}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unported_branches_still_raise(case):
    """Each branch builds, or (Guided in the 1/8 stack, which the JAX
    package cannot run either: its 1/8 stack passes no guide) raises."""
    from casmtr_tpu_torch.models import build_model
    ov = tiny_indoor_overrides()
    for part, value in REFUSED[case].items():
        ov["loftr"][part].update(value)
    _, tcfg = configs(ov, RECIPE)
    if case not in PORTED:
        with pytest.raises(ValueError, match="passes none"):
            build_model(tcfg.loftr)
        return
    model = build_model(tcfg.loftr)
    if PORTED[case] == "detector":
        assert (model.loftr_coarse_4c.detector is not None) == (
            case == "detector")
    elif case == "coarse relative PE":
        assert len(model.loftr_coarse_8c.w_pos_bias) == 3
    else:
        assert type(model.loftr_coarse_4c.layers[0]).__name__ == PORTED[case]
