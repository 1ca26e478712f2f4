"""CasMTR-2c in the port against the JAX package, on the CPU at the tiny 2c
configuration (tests/torch_parity.py: the full 2c wiring at tiny widths,
Twins backbone at its smallest preset), with the same jittered weights:

* the eval forward, with the recipe's thresholds and with every threshold
  at 0 (so every stage yields matches): equal valid (b, i, j) sets at the
  1/8, 1/4 and 1/2 stages and at the end, keypoints within 1e-3 px,
  confidences and the 1/2 window confidences within 1e-4;
* ``Matcher("outdoor_casmtr_2c")`` against the JAX ``Matcher`` on a square
  and a padded request;
* one training step against the JAX package's step and the gradients it
  takes (``step_gradients``): loss terms within 1e-5 relative, per-leaf gradients
  within 1e-4 relative (leaf norms floored as in test_torch_train.py),
  BatchNorm statistics within 1e-5;
* ``load_jax_variables`` fills every key of the 2c model (``up_block2``,
  ``loftr_coarse_2c``) from the flax tree, and stays strict."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_slice import (_assert_same_matches, _by_pair,  # noqa
                                    _fields, _images)
from tests.test_torch_train import (_jnp, _leaves, _pair_batch,  # noqa
                                    step_gradients)
from tests.torch_parity import (configs, jitter, port_variables,  # noqa
                                tiny_2c_overrides)

RECIPE = "outdoor_casmtr_2c"
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
TRAIN_SIZE = 64


# --------------------------------------------------------------------------
# the eval forward
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["recipe_thresholds",
                                        "zero_thresholds"])
def eval_run(request):
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    zero = request.param == "zero_thresholds"
    jcfg, tcfg = configs(tiny_2c_overrides(zero_thresholds=zero), RECIPE)
    img0, img1 = _images(np.random.default_rng(0), 2, 128, 128)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxCasMTR(jcfg.loftr)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    return zero, got, want


def _same_valid_sets(got, want):
    """Equal valid (b, i, j) sets with close confidences and keypoints; an
    empty set is allowed (thresholds above a random model's confidences)."""
    if len(_by_pair(want)[0]) or len(_by_pair(got)[0]):
        _assert_same_matches(got, want)


def test_2c_eval_forward_stages_match_jax(eval_run):
    zero, got, want = eval_run
    assert set(got.cascades) == set(want.cascades) == {"4c", "2c"}
    stages = [(got.coarse.matches, want.coarse.matches)] + [
        (got.cascades[n].matches, want.cascades[n].matches)
        for n in ("4c", "2c")]
    for g, w in stages:
        g, w = _fields(g), _fields(w)
        if zero:
            assert g["valid"].sum() > 0
        _same_valid_sets(g, w)
    for n in ("4c", "2c"):
        assert got.cascades[n].hw0 == tuple(want.cascades[n].hw0)
        np.testing.assert_allclose(got.cascades[n].conf_matrix.numpy(),
                                   np.asarray(want.cascades[n].conf_matrix),
                                   rtol=0, atol=CONF_ATOL)
    assert got.cascades["2c"].hw0 == (64, 64)


def test_2c_eval_forward_final_matches_match_jax(eval_run):
    zero, got, want = eval_run
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    # the final matches are the 1/2 stage's, refined
    np.testing.assert_array_equal(
        got_f["i_ids"], got.cascades["2c"].matches.i_ids.numpy())
    assert got_f["valid"].sum() > 0  # keep-at-least-one at every threshold
    _assert_same_matches(got_f, want_f)


def test_matcher_2c_answers_like_jax_matcher():
    """Two requests through both Matchers with the same weights: a square
    pair, and a 128x64 pair that the 128 bucket pads (masks on the path)."""
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = tiny_2c_overrides(zero_thresholds=True)
    jmatch = JaxMatcher(RECIPE, bucket=128, df=32, thr=0.0, overrides=ov)
    jmatch.variables = jitter(jmatch.variables, seed=2)
    tmatch = Matcher(RECIPE, bucket=128, df=32, thr=0.0, overrides=ov,
                     device="cpu")
    load_jax_variables(tmatch.model, jmatch.variables)
    rng = np.random.default_rng(1)
    a0, a1 = _images(rng, 1, 128, 128)
    b0, b1 = _images(rng, 1, 128, 64)
    for img0, img1 in ((a0[0], a1[0]), (b0[0], b1[0])):
        want = jmatch.match(img0, img1)
        got = tmatch.match(img0, img1)
        assert len(want.mconf) > 0
        assert len(got.mconf) == len(want.mconf)
        og = np.lexsort(got.mkpts0.T)
        ow = np.lexsort(want.mkpts0.T)
        for name, atol in (("mkpts0", PX_ATOL), ("mkpts1", PX_ATOL),
                           ("mconf", CONF_ATOL)):
            np.testing.assert_allclose(getattr(got, name)[og],
                                       getattr(want, name)[ow], rtol=0,
                                       atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# one training step
# --------------------------------------------------------------------------

def _step_overrides():
    """The tiny 2c configuration at 64^2; the double checks are off so that
    the random-weight model keeps enough matches at both cascade levels for
    their losses and the fine loss to carry gradients."""
    ov = tiny_2c_overrides(train_size=TRAIN_SIZE)
    ov["loftr"]["match_cascade"]["double_check"] = [False, False]
    return ov


@pytest.fixture(scope="module")
def step_run():
    """One step of each package from the same jittered variables and batch;
    the flax side jitted once, its tree from ``jax.eval_shape`` and its
    values from the port's seeded initialization, jittered."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu.train.optim import build_optimizer as jax_build
    from casmtr_tpu.train.train_step import TrainState as JaxState
    from casmtr_tpu.train.train_step import make_train_step as jax_step
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import (init_random_, jax_variables,
                                          load_jax_variables)
    jcfg, tcfg = configs(_step_overrides(), RECIPE)
    batch = _pair_batch(size=TRAIN_SIZE)
    jm = JaxCasMTR(jcfg.loftr)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            _jnp(batch), train=False))
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  dict(shapes))
    model = build_model(tcfg.loftr)
    init_random_(model, torch.Generator().manual_seed(1))
    variables = jitter(jax_variables(model.state_dict(), like), seed=1)
    load_jax_variables(model, variables)

    tx = jax_build(jcfg.trainer, 1e-3, 100)
    step_fn = jax_step(jm, jcfg, tx)
    taken = []

    def both_fn(s, b):
        with step_gradients(taken):
            out = step_fn(s, b)
        return out, taken[-1]

    both = jax.jit(both_fn)
    p0 = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state0 = JaxState(jnp.zeros((), jnp.int32), p0,
                      jax.tree_util.tree_map(jnp.asarray,
                                             variables["batch_stats"]),
                      tx.init(p0))
    (jstate1, jscalars), jgrads = both(state0, _jnp(batch))

    state, ttx = init_train_state(model, tcfg, 100, 1e-3, device="cpu")
    step = make_train_step(model, tcfg, ttx, device="cpu")
    kernels_before = _launches()
    state, tscalars = step(state, batch)
    assert _launches() == kernels_before  # CPU: the plain versions
    tgrads = jax_variables(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()}, {"params": like["params"]})
    tstats = jax_variables(model.state_dict(),
                           {"batch_stats": like["batch_stats"]})
    return dict(jstate0=state0, jstate1=jstate1, jscalars=jscalars,
                jgrads=jgrads, tscalars=tscalars, tgrads=tgrads["params"],
                tstats=tstats["batch_stats"])


def _launches():
    from casmtr_tpu_torch.ops import kernels
    return dict(kernels.LAUNCHES)


def test_2c_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js)
    assert {"loss_2c", "valid_n_2c"} <= set(ts)
    for k in ("loss", "loss_8c", "loss_4c", "loss_2c", "loss_f",
              "grad_norm"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    for lvl in ("4c", "2c"):
        assert int(ts[f"valid_n_{lvl}"]) == int(js[f"valid_n_{lvl}"]) > 0
    assert float(ts["loss_2c"]) > 0 and float(ts["loss_f"]) > 0


def test_2c_train_step_gradients_match_jax(step_run):
    want = _leaves(step_run["jgrads"])
    got = _leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    assert any("loftr_coarse_2c" in k for k in want)
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * scale, f"{k}: relative error {err / scale}"
    nonzero = sum(float(np.abs(w).sum()) > 0 for w in want.values())
    assert nonzero > 0.9 * len(want)


def test_2c_train_step_batch_stats_match_jax(step_run):
    want = _leaves(step_run["jstate1"].batch_stats)
    got = _leaves(step_run["tstats"])
    start = _leaves(step_run["jstate0"].batch_stats)
    assert got.keys() == want.keys()
    assert any("up_block2" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def test_load_jax_variables_strict_on_the_2c_tree():
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    jcfg, tcfg = configs(tiny_2c_overrides(), RECIPE)
    batch = {k: jnp.zeros((1, 64, 64, 3), jnp.float32)
             for k in ("image0", "image1")}
    shapes = jax.eval_shape(lambda: JaxCasMTR(jcfg.loftr).init(
        jax.random.PRNGKey(0), batch, train=False))
    variables = jitter(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
    assert {"up_block2", "loftr_coarse_2c"} <= set(variables["params"])
    model = CasMTR(tcfg.loftr)
    load_jax_variables(model, variables)
    sd = model.state_dict()
    w = variables["params"]["loftr_coarse_2c"]
    q = w["layers_0"]["attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(
        sd["loftr_coarse_2c.layers.0.attn.q_proj.weight"].numpy(), q.T)
    stats = variables["batch_stats"]["up_block2"]["up_1"]["mean"]
    np.testing.assert_array_equal(sd["up_block2.up.1.running_mean"].numpy(),
                                  stats)
    del variables["params"]["up_block2"]
    with pytest.raises(KeyError, match="up_block2"):
        load_jax_variables(CasMTR(tcfg.loftr), variables)
