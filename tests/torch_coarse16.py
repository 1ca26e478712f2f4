"""The tests that tests/test_torch_coarse16_resnet.py (R16: ResNetFPN_16_4)
and tests/test_torch_coarse16_twins.py (T16: TwinsFPN_16_8_4_2) share:
``quadtree_baseline`` on a 1/16 backbone at tiny widths
(``torch_parity.tiny_coarse16_overrides``), the port against the JAX
package on the CPU with the same jittered weights.  Each test file imports
them and defines the module fixture ``kind`` ("R16" or "T16").

* the eval forward with every threshold at 0, square (128^2) and
  non-square (128x192: the 1/16 grid 8x12, whose quadtree levels 4x6 and
  2x3 stay whole), and ``Matcher("quadtree_baseline")`` on a square and a
  padded request, at test_torch_quadtree_loftr.py's tolerances: the same
  valid (b, i, j) sets at the coarse stage and at the end, keypoints
  within 1e-3 px, confidences and fine offsets within 1e-4;
* one training step on ``_pair_batch(size=128, shift=8)`` with the coarse
  threshold at 0, against the JAX package's step and ``jax.grad`` of the
  same composition (traced with flax's BatchNorm in the port's two-pass
  variance, ``torch_parity.two_pass_batch_norm``), at that file's
  tolerances: loss terms within 1e-5 relative, per-leaf gradients within
  1e-4 relative (leaf norms floored at 1e-3 of the whole gradient's),
  BatchNorm statistics within 1e-5; loss_f > 0 in both packages.  The
  coarse ground truth is taken at ``coarse_level`` 16 and the fine one at
  ``resolution[1]`` in both (for T16 that is 8, against its 1/2 fine map:
  the JAX package's rule, ROADMAP section C);
* the port's state dict under ``matcher.`` through the JAX package's
  ``convert_state_dict(strict=True)``, and a reference-format state dict
  written from the flax variables through the port's, each with nothing
  missing or unused and every number equal;
* both packages refuse a cascade on the 1/16 backbone (the JAX CasMTR
  unpacks three maps; the port raises ValueError when it is built).

The tolerances are those of the files named; none was loosened here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_slice import (_assert_same_matches, _fields,  # noqa
                                    _images)
from tests.test_torch_train import _leaves as leaves  # noqa: E402
from tests.test_torch_train import (_pair_batch, jax_step,  # noqa: E402
                                    step_variables, torch_step)
from tests.torch_parity import (configs, flax_like,  # noqa: E402
                                flax_to_torch_sd, port_variables,
                                tiny_coarse16_overrides)

RECIPE = "quadtree_baseline"
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
SIZE = 128       # three quadtree levels at 1/16: 8^2, 4^2, 2^2
SHIFT = 8


def grad_errors(got, want):
    """Per-leaf relative gradient errors, leaf norms floored at 1e-3 of the
    whole gradient's (test_torch_train.py's rule), by leaf."""
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    return {k: float(np.linalg.norm(got[k] - w))
            / max(float(np.linalg.norm(w)), 1e-3 * total)
            for k, w in want.items()}


def _jax_init(jcfg):
    from casmtr_tpu.models import build_model
    jm = build_model(jcfg.loftr)
    b = {k: jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
         for k in ("image0", "image1")}
    return jm, lambda: jm.init(jax.random.PRNGKey(0), b, train=False)


# --------------------------------------------------------------------------
# the eval forward and the Matcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(SIZE, SIZE), (SIZE, 192)],
                         ids=["square", "non-square"])
def test_coarse16_eval_forward_matches_jax(kind, hw):
    from casmtr_tpu.models.loftr import QuadtreeLoFTR as JaxQuadtreeLoFTR
    from casmtr_tpu_torch.models.loftr import QuadtreeLoFTR
    from casmtr_tpu_torch.weights import load_jax_variables
    from tests.torch_parity import jax_eval
    jcfg, tcfg = configs(tiny_coarse16_overrides(kind, zero_thresholds=True),
                         RECIPE)
    img0, img1 = _images(np.random.default_rng(0), 2, *hw)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxQuadtreeLoFTR(jcfg.loftr)
    model = QuadtreeLoFTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    want = jax_eval(jm, variables, batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    assert got.coarse.hw0 == (hw[0] // 16, hw[1] // 16)
    _assert_same_matches(_fields(got.coarse.matches),
                         _fields(want.coarse.matches))
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    assert got_f["valid"].sum() > 0
    _assert_same_matches(got_f, want_f)


def test_coarse16_matcher_answers_like_jax_matcher(kind):
    """A square request and a 128x64 one that the 128 bucket pads (masks on
    the path), through both Matchers with the same weights: the port's
    seeded initialization, jittered, as in the other tests here.  (On the
    JAX Matcher's own initialization, jittered, the tiny T16's fine
    heatmap logits reach ~2000, and one of its 16 keypoints differed by
    1.01e-3 px; a relative nudge of 1e-7 of the images moves that keypoint
    by 4.7e-4 px in the JAX Matcher alone and by 7.7e-4 px in the port's:
    float32 rounding decides the last 1e-3 px there.)"""
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = tiny_coarse16_overrides(kind, zero_thresholds=True)
    jmatch = JaxMatcher(RECIPE, bucket=SIZE, df=64, thr=0.0, overrides=ov)
    tmatch = Matcher(RECIPE, bucket=SIZE, df=64, thr=0.0, overrides=ov,
                     device="cpu")
    jmatch.variables = port_variables(tmatch.model, lambda: jmatch.variables)
    load_jax_variables(tmatch.model, jmatch.variables)
    rng = np.random.default_rng(1)
    a0, a1 = _images(rng, 1, SIZE, SIZE)
    b0, b1 = _images(rng, 1, SIZE, 64)
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

def coarse16_step_run(kind, **coarse):
    """One step of each package from the same jittered variables and batch
    (``coarse`` overrides the tiny coarse stack), the coarse threshold at
    0 so that the random model's matches include some close enough to
    their ground truth for the fine loss to count them."""
    ov = tiny_coarse16_overrides(kind, train_size=SIZE, zero_thresholds=True)
    ov["loftr"]["coarse"].update(coarse)
    jcfg, tcfg = configs(ov, RECIPE)
    assert jcfg.loftr.coarse_level == tcfg.loftr.coarse_level == 16
    batch = _pair_batch(size=SIZE, shift=SHIFT)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    return dict(zip(("jscalars", "jgrads", "jstats"),
                    jax_step(jm, jcfg, variables, batch, two_pass_bn=True)),
                **dict(zip(("tscalars", "tgrads", "tstats"),
                           torch_step(tcfg, variables, like, batch))),
                start=variables["batch_stats"])


def test_coarse16_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js) == {"loss", "loss_8c", "loss_f", "grad_norm"}
    for k in ("loss", "loss_8c", "loss_f", "grad_norm"):
        print(f"{k}: {float(ts[k]):.6g} against {float(js[k]):.6g}, relative"
              f" error {abs(float(ts[k]) / float(js[k]) - 1):.2e}")
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    assert float(ts["loss_f"]) > 0 and float(js["loss_f"]) > 0


def test_coarse16_train_step_gradients_match_jax(step_run):
    want, got = leaves(step_run["jgrads"]), leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    assert any("layer3_outconv2" in k for k in want)
    for k, err in grad_errors(got, want).items():
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_RTOL, f"{k}: relative error {err}"


def test_coarse16_train_step_batch_stats_match_jax(step_run):
    want, got = leaves(step_run["jstats"]), leaves(step_run["tstats"])
    start = leaves(step_run["start"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"


# --------------------------------------------------------------------------
# weights and the cascade
# --------------------------------------------------------------------------

def test_coarse16_reference_state_dict_round_trip_is_strict(kind):
    """The port's state dict (the reference's names and layouts) under
    ``matcher.`` through the JAX package's strict conversion gives the
    flax variables back exactly; the reference-format state dict written
    from those variables loads strictly into a port model of other seeded
    weights, every tensor equal to the first model's."""
    from casmtr_tpu.utils.convert import convert_state_dict as jax_convert
    from casmtr_tpu_torch.models.loftr import QuadtreeLoFTR
    from casmtr_tpu_torch.utils.convert import convert_state_dict
    from casmtr_tpu_torch.weights import init_random_, load_jax_variables
    jcfg, tcfg = configs(tiny_coarse16_overrides(kind), RECIPE)
    _, init = _jax_init(jcfg)
    model = QuadtreeLoFTR(tcfg.loftr)
    variables = port_variables(model, init, seed=3)
    load_jax_variables(model, variables)
    sd = model.state_dict()
    converted, report = jax_convert({"matcher." + k: v
                                     for k, v in sd.items()},
                                    flax_like(init), strict=True)
    assert report == {"missing": [], "unused": []}
    got, want = leaves(converted), leaves(variables)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    ref = {}
    for col in ("params", "batch_stats"):
        ref.update(flax_to_torch_sd(variables[col], shapes))
    other = QuadtreeLoFTR(tcfg.loftr)
    init_random_(other, torch.Generator().manual_seed(9))
    assert convert_state_dict(ref, other, strict=True) == {"missing": [],
                                                           "unused": []}
    for k, v in other.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_coarse16_backbone_under_a_cascade_is_refused(kind):
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    ov = tiny_coarse16_overrides(kind)
    ov["loftr"]["cascade"] = True
    jcfg, tcfg = configs(ov, RECIPE)
    b = {k: jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
         for k in ("image0", "image1")}
    with pytest.raises(ValueError, match="values to unpack"):
        jax.eval_shape(lambda: JaxCasMTR(jcfg.loftr).init(
            jax.random.PRNGKey(0), b, train=False))
    with pytest.raises(ValueError, match="under a cascade"):
        CasMTR(tcfg.loftr)
