"""The port's test-time filters and gates against the JAX package's, on the
CPU with the same numpy inputs:

* ``ops/nms.py``: local-window NMS (random and deliberately tied
  confidences: ties to the lower index), soft-argmax NMS with stride 1 and
  with stride equal to the window (a tile grid that divides the level and
  one that does not), the d2d saliency (within 1e-6) and mask (random and
  tied saliency), every mask exactly equal;
* ``ops/sift.py``: the 2x upsampling (within 1e-6, edges included), the
  keypoint sets and the cell mask of test_sift's blob images, with and
  without a valid mask, exactly equal; an image too small for the pyramid
  refused by both; the Matcher's padded canvas and its valid mask handed
  to the detector;
* the second-best tracking of the dual softmax and of the window softmax:
  values within 1e-6, indices equal;
* ``cascade_match_mask_test`` on the same window-softmax result with the
  rt and rd gates, d2d, sift, top-k and temperature/stride set: equal
  masks;
* tiny 4c forwards with each of the filters F1-F6 (torch_parity.FILTERS),
  a tiny 2c forward with F4 at 1/4 and F6 at 1/2, and the tiny refine
  model with d2d and an rt gate (which both packages ignore there), on the
  tiny ResNetFPN: every threshold at 0, the double check off and each
  level's capacity its positions, so each level's matches are its whole
  keep mask; the same valid (b, i, j) sets at every stage, keypoints
  within 1e-3 px and confidences within 1e-4 (test_torch_slice.py's
  tolerances).

The tolerances were fixed before the first run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_sift import _blob_image  # noqa: E402
from tests.test_torch_slice import (_assert_same_matches, _fields,  # noqa
                                    _images)
from tests.torch_parity import (FILTERS, configs, fast_jit,  # noqa: E402
                                jax_eval, port_variables, tiny_2c_overrides,
                                tiny_4c_overrides)

VALUE_ATOL = 1e-6


def _jit(fn, **static):
    """``fn`` with the keyword arguments ``static`` bound, through fast_jit
    (eager JAX would compile every primitive on its own)."""
    return fast_jit(lambda *a, **k: fn(*a, **k, **static))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tensor(a):
    """The port's tensor of a numpy array: indices as int64, as the port
    makes them."""
    t = torch.from_numpy(a)
    return t.long() if a.dtype == np.int32 else t


def _tied(rng, shape, levels=3):
    """Values of only ``levels`` distinct levels: ties everywhere."""
    return (rng.integers(0, levels, shape) / levels).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_local_window_nms_matches_jax(kind):
    from casmtr_tpu.ops import nms as jn
    from casmtr_tpu_torch.ops import nms as tn
    rng = np.random.default_rng(0)
    hw = (12, 16)
    conf = (rng.random((2, 192)).astype(np.float32) if kind == "random"
            else _tied(rng, (2, 192)))
    got = tn.local_window_nms_mask(torch.from_numpy(conf), hw, 4, 3)
    _equal(got, _jit(jn.local_window_nms_mask, hw=hw, window=4, topk=3)(
        jnp.asarray(conf)))
    assert int(got.sum()) == 2 * 12 * 3


SOFTARGMAX = {"stride 1": ((12, 14), 5, 1, 0.5),
              "tiled": ((16, 16), 4, 4, 1.0),
              "tiled, partial tiles": ((13, 17), 5, 5, 0.7)}


@pytest.mark.parametrize("case", list(SOFTARGMAX))
def test_softargmax_nms_matches_jax(case):
    from casmtr_tpu.ops import nms as jn
    from casmtr_tpu_torch.ops import nms as tn
    hw, window, stride, temp = SOFTARGMAX[case]
    conf = np.random.default_rng(1).random((2, hw[0] * hw[1]),
                                           dtype=np.float32) * 4
    got = tn.softargmax_nms_mask(torch.from_numpy(conf), hw, window, temp,
                                 stride)
    _equal(got, _jit(jn.softargmax_nms_mask, hw=hw, window=window,
                     temperature=temp, stride=stride)(jnp.asarray(conf)))
    assert got.any()


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_d2d_matches_jax(kind):
    from casmtr_tpu.ops import nms as jn
    from casmtr_tpu_torch.ops import nms as tn
    rng = np.random.default_rng(2)
    hw, C = (16, 20), 12
    feat = rng.standard_normal((2, hw[0] * hw[1], C)).astype(np.float32)
    conf = rng.random((2, hw[0] * hw[1])).astype(np.float32)
    s_t = tn.d2d_saliency(torch.from_numpy(feat), hw)
    s_j = _jit(jn.d2d_saliency, hw=hw)(jnp.asarray(feat))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=VALUE_ATOL)
    # the mask from one saliency in both packages (tied: three levels)
    sal = (np.array(s_j) if kind == "random"
           else _tied(rng, tuple(s_j.shape)))
    got = tn.d2d_mask(torch.from_numpy(conf), hw, 5, torch.from_numpy(sal),
                      hw[1] // 4)
    _equal(got, _jit(jn.d2d_mask, hw=hw, window=5, d2d_w=hw[1] // 4)(
        jnp.asarray(conf), s_d2d=jnp.asarray(sal)))
    assert 0 < int(got.sum()) < hw[0] * hw[1]


def _blobs():
    """Two of test_sift's 128^2 blob images (one upside down)."""
    img = _blob_image(128, 128, [(32, 40), (80, 96), (60, 20), (100, 30)])
    return np.stack([img, img[::-1].copy()])


@pytest.mark.parametrize("masked", [False, True])
def test_sift_matches_jax(masked):
    """Without a valid mask, and with one that cuts the lower rows of both
    images and the right columns of the second."""
    from casmtr_tpu.ops import sift as js
    from casmtr_tpu_torch.ops import sift as ts
    gray = _blobs()
    kw_j, kw_t = {}, {}
    if masked:
        vm = np.ones(gray.shape, bool)
        vm[:, 70:] = False
        vm[1, :, 100:] = False
        kw_j, kw_t = ({"valid_mask": jnp.asarray(vm)},
                      {"valid_mask": torch.from_numpy(vm)})
    # the 2x upsampling, edge rows and columns included
    up = ts._upsample2(torch.from_numpy(gray))
    np.testing.assert_allclose(up.numpy(), np.asarray(js._upsample2(
        jnp.asarray(gray))), rtol=0, atol=VALUE_ATOL)
    xy, valid = ts.scale_space_keypoints(torch.from_numpy(gray), **kw_t)
    jxy, jvalid = _jit(js.scale_space_keypoints)(jnp.asarray(gray), **kw_j)
    # the keypoint sets (blobs of one shape respond alike, so their order
    # by response is rounding's)
    _equal(valid.sum(1), np.asarray(jvalid).sum(1))
    for b in range(2):
        got_b = xy[b][valid[b]].numpy()
        want_b = np.asarray(jxy[b])[np.asarray(jvalid[b])]
        np.testing.assert_array_equal(got_b[np.lexsort(got_b.T)],
                                      want_b[np.lexsort(want_b.T)])
    assert int(valid.sum()) >= 4
    rgb = np.repeat(gray[..., None], 3, axis=3)
    got = ts.sift_cell_mask(torch.from_numpy(rgb), (16, 16), 8, **kw_t)
    _equal(got, _jit(js.sift_cell_mask, hw_c=(16, 16), stride=8)(
        jnp.asarray(rgb), **kw_j))
    assert 0 < int(got.sum()) < 2 * 64


def test_sift_refuses_a_too_small_image_in_both():
    from casmtr_tpu.ops import sift as js
    from casmtr_tpu_torch.ops import sift as ts
    with pytest.raises(ValueError, match="too small"):
        js.scale_space_keypoints(jnp.zeros((1, 24, 24)))
    with pytest.raises(ValueError, match="too small"):
        ts.scale_space_keypoints(torch.zeros((1, 24, 24)))


def _window_inputs(rng, L0=64, L1=80, Kw=9, C=8):
    f0 = rng.standard_normal((2, L0, C)).astype(np.float32)
    f1 = rng.standard_normal((2, L1, C)).astype(np.float32)
    idx01 = rng.integers(0, L1, (2, L0, Kw)).astype(np.int32)
    idx10 = rng.integers(0, L0, (2, L1, Kw)).astype(np.int32)
    return f0, f1, idx01, idx10


@pytest.mark.parametrize("which", ["dual softmax", "window softmax"])
def test_second_best_tracking_matches_jax(which):
    rng = np.random.default_rng(3)
    if which == "dual softmax":
        from casmtr_tpu.ops import matching as jm
        from casmtr_tpu_torch.ops import matching as tm
        f0 = rng.standard_normal((2, 30, 8)).astype(np.float32)
        f1 = rng.standard_normal((2, 40, 8)).astype(np.float32)
        # a duplicated column: second-best ties to the first index
        f1[:, 7] = f1[:, 3]
        want = _jit(jm.dual_softmax, temperature=0.1, track_second=True)(
            jnp.asarray(f0), jnp.asarray(f1))
        got = tm.dual_softmax(torch.from_numpy(f0), torch.from_numpy(f1),
                              0.1, track_second=True)
    else:
        from casmtr_tpu.ops import cascade_matching as jc
        from casmtr_tpu_torch.ops import cascade_matching as tc
        f0, f1, idx01, idx10 = _window_inputs(rng)
        idx01[:, :, 4] = idx01[:, :, 2]      # repeated candidates: ties
        want = _jit(jc.window_softmax_matching, temperature=0.1,
                    track_second=True)(*map(jnp.asarray,
                                            (f0, f1, idx01, idx10)))
        got = tc.window_softmax_matching(
            *map(torch.from_numpy, (f0, f1, idx01, idx10)), 0.1,
            track_second=True)
    np.testing.assert_allclose(got.next_conf_c01_s.numpy(),
                               np.asarray(want.next_conf_c01_s), rtol=0,
                               atol=VALUE_ATOL)
    _equal(got.next_idx_c01_s, want.next_idx_c01_s)
    _equal(got.next_idx_c01, want.next_idx_c01)


MASK_CASES = {
    "local_window_nms, rt, rd": dict(post_method="local_window_nms",
                                     post_window=4, post_topk=2, rt=0.9,
                                     rd=0.3),
    "softargmax stride 4, temperature, rt": dict(
        post_method="softargmax_nms", post_window=4, post_stride=4,
        post_temperature=0.5, rt=0.95),
    "d2d, rd": dict(post_method="d2d", post_window=5, rd=0.4),
    "sift, rt, rd": dict(post_method="sift", post_window=None, rt=0.9,
                         rd=0.3),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_cascade_match_mask_test_matches_jax(case):
    """One window-softmax result (the JAX package's, handed to both) on a
    16 x 16 level under an 8 x 8 coarse level; the level's image 64^2,
    the lower rows of image0 padded for sift."""
    from casmtr_tpu.ops import cascade_matching as jc
    from casmtr_tpu.ops import nms as jn
    from casmtr_tpu_torch.ops import cascade_matching as tc
    from casmtr_tpu_torch.ops import nms as tn
    rng = np.random.default_rng(4)
    hw, hw8 = (16, 16), (8, 8)
    f0, f1, idx01, idx10 = _window_inputs(rng, 256, 256, 9, 8)
    ws = _jit(jc.window_softmax_matching, temperature=0.2,
              track_second=True)(*map(jnp.asarray, (f0, f1, idx01, idx10)))
    ws_np = {k: np.asarray(v) for k, v in ws._asdict().items()
             if v is not None and k in tc.WindowSoftmaxResult._fields}
    tws = tc.WindowSoftmaxResult(**{k: _tensor(v)
                                    for k, v in ws_np.items()})
    pre = rng.random((2, 64)).astype(np.float32)
    pre_s = (pre * rng.random((2, 64))).astype(np.float32)
    idx8 = rng.integers(0, 64, (2, 64)).astype(np.int32)
    idx8_s = rng.integers(0, 64, (2, 64)).astype(np.int32)
    kw = dict(MASK_CASES[case])
    extra_j, extra_t = {}, {}
    if kw["post_method"] == "d2d":
        feat = rng.standard_normal((2, 256, 8)).astype(np.float32)
        extra_j = dict(s_d2d=jn.d2d_saliency(jnp.asarray(feat), hw), d2d_w=4)
        extra_t = dict(s_d2d=tn.d2d_saliency(torch.from_numpy(feat), hw),
                       d2d_w=4)
    if kw["post_method"] == "sift":
        img = np.repeat(_blob_image(64, 64, [(20, 24), (40, 44)])[None, ...,
                                                                   None],
                        2, 0).repeat(3, 3)
        mask = np.ones((2, 64, 64), bool)
        mask[1, 48:] = False
        extra_j = dict(image0=jnp.asarray(img), image0_mask=jnp.asarray(mask))
        extra_t = dict(image0=torch.from_numpy(img),
                       image0_mask=torch.from_numpy(mask))

    def run(mod, ws_, pre, pre_s, idx8, idx8_s, extra):
        return mod.cascade_match_mask_test(
            ws_, hw, hw, 0.01, 1, pre_confs=[pre], pre_hws=[hw8],
            pre_thrs=[0.05], double_check=False, pre_confs_s=[pre_s],
            rd_coarse=(idx8, idx8_s, hw8) if "rd" in kw else None, **kw,
            **extra)

    arrays = (pre, pre_s, idx8, idx8_s)
    want = _jit(lambda *a, **k: run(jc, *a, k))(
        ws, *map(jnp.asarray, arrays), **extra_j)
    got = run(tc, tws, *map(_tensor, arrays), extra_t)
    _equal(got, want)
    assert 1 < int(got.sum()) < 2 * 256


def _capacious(ov, levels, size, pairs=2):
    """Thresholds at 0 (the caller's), the double check off and each
    level's capacity its positions in the batch: each level's matches are
    its whole keep mask."""
    mc = ov["loftr"]["match_cascade"]
    mc["double_check"] = [False] * levels
    mc["max_matches"] = [pairs * (size // s) ** 2 for s in (4, 2)[:levels]]
    return ov


# 4c with each filter; 2c with d2d at 1/4 and the gates at 1/2 (whose rt
# gate makes the 1/4 level track its second best, and reads it)
FORWARDS = {f"4c {f}": ("outdoor_casmtr_4c", (f,)) for f in FILTERS}
FORWARDS["2c F4 F6"] = ("outdoor_casmtr_2c", ("F4", "F6"))
SIZE = 64
# the tiny configurations on the tiny ResNetFPN (the filters do not read
# the backbone; its flax graph traces and compiles faster than Twins')
RESNET = {"backbone_type": "ResNetFPN", "initial_dim": 8,
          "block_dims": [8, 12, 16]}


def _overrides(recipe, filters=()):
    two = recipe.endswith("2c")
    ov = (tiny_2c_overrides if two else tiny_4c_overrides)(
        zero_thresholds=True)
    ov["loftr"]["backbone"] = dict(RESNET)
    ov = _capacious(ov, 2 if two else 1, SIZE)
    for stage, name in zip(("coarse2", "coarse3"), filters):
        ov["loftr"][stage]["post_config"] = dict(FILTERS[name])
    return ov


@pytest.fixture(scope="module")
def variables():
    """Per recipe, the jittered weights both packages load (the post
    config changes no parameter)."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    out = {}
    batch = {k: jnp.zeros((1, SIZE, SIZE, 3)) for k in ("image0", "image1")}
    for recipe in {r for r, _ in FORWARDS.values()}:
        jcfg, tcfg = configs(_overrides(recipe), recipe)
        jm = JaxCasMTR(jcfg.loftr)
        out[recipe] = port_variables(CasMTR(tcfg.loftr), lambda: jm.init(
            jax.random.PRNGKey(0), batch, train=False))
    return out


@pytest.mark.parametrize("case", list(FORWARDS))
def test_filtered_forward_matches_jax(case, variables):
    """A tiny forward with the filters on its cascade levels, both packages
    from the same jittered weights; F5 (sift) on a pair whose lower rows
    are padding, so its detector reads image0's valid mask."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    recipe, filters = FORWARDS[case]
    jcfg, tcfg = configs(_overrides(recipe, filters), recipe)
    img0, img1 = _images(np.random.default_rng(0), 2, SIZE, SIZE)
    batch = {"image0": img0, "image1": img1}
    if "F5" in filters:
        mask = np.ones((2, SIZE, SIZE), bool)
        mask[:, 3 * SIZE // 4:] = False
        batch.update(mask0=mask, mask1=mask)
    want = jax_eval(JaxCasMTR(jcfg.loftr), variables[recipe],
                    {k: jnp.asarray(v) for k, v in batch.items()})
    model = CasMTR(tcfg.loftr)
    load_jax_variables(model, variables[recipe])
    model.eval()
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.cascades.keys() == want.cascades.keys()
    for level in want.cascades:
        g = _fields(got.cascades[level].matches)
        assert g["valid"].sum() > 1, level
        _assert_same_matches(g, _fields(want.cascades[level].matches))
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    _assert_same_matches(got_f, want_f)


def test_refine_filtered_forward_matches_jax():
    """The tiny refine model with d2d at 1/4 and an rt gate, which neither
    package's refine model reads."""
    from casmtr_tpu.models.casmtr_refine import CasMTRRefine as JaxRefine
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.weights import load_jax_variables
    from tests.test_torch_refine import RECIPE, tiny_refine_overrides
    ov = _capacious(tiny_refine_overrides(zero_thresholds=True), 1, SIZE)
    ov["loftr"]["coarse2"]["post_config"] = dict(FILTERS["F4"], rt=0.5)
    jcfg, tcfg = configs(ov, RECIPE)
    img0, img1 = _images(np.random.default_rng(0), 2, SIZE, SIZE)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxRefine(jcfg.loftr)
    model = build_model(tcfg.loftr, refine=True)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    want = jax_eval(jm, variables, batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    g = _fields(got.cascades["4c"].matches)
    assert g["valid"].sum() > 1
    _assert_same_matches(g, _fields(want.cascades["4c"].matches))
    _assert_same_matches(_fields(got.final_matches),
                         _fields(want.final_matches))


def test_matcher_hands_sift_its_canvas_and_valid_mask(monkeypatch):
    """A Matcher with sift on its tiny 4c: the detector reads the padded
    canvas image0 and the canvas's valid mask (False on the padding)."""
    from casmtr_tpu_torch.ops import sift
    from casmtr_tpu_torch.serving import Matcher
    ov = tiny_4c_overrides()
    ov["loftr"]["coarse2"]["post_config"] = dict(FILTERS["F5"])
    seen = {}
    detect = sift.sift_cell_mask

    def record(image0, hw_c, stride, **kw):
        seen.update(image0=image0, hw_c=hw_c, stride=stride, **kw)
        return detect(image0, hw_c, stride, **kw)

    monkeypatch.setattr(sift, "sift_cell_mask", record)
    m = Matcher("outdoor_casmtr_4c", bucket=128, df=32, overrides=ov,
                device="cpu")
    img0, img1 = _images(np.random.default_rng(3), 1, 96, 128)
    m.match(img0[0], img1[0])
    assert seen["image0"].shape == (1, 128, 128, 3)
    assert seen["hw_c"] == (32, 32) and seen["stride"] == 4
    want = np.zeros((1, 128, 128), bool)
    want[:, :96] = True
    np.testing.assert_array_equal(seen["valid_mask"].numpy(), want)
    np.testing.assert_array_equal(seen["image0"][0, :96].numpy(), img0[0])
