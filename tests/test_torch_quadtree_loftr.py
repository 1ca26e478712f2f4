"""QuadtreeLoFTR (the ``quadtree_baseline`` recipe) in the port against the
JAX package, on the CPU at tiny widths (tests/torch_parity.py
``tiny_baseline_overrides``: ResNetFPN_8_2 in gray, one self and one cross
quadtree layer, the LoFTR fine stage), with the same jittered weights:

* ``build_model`` returns QuadtreeLoFTR for the recipe, CasMTR for the
  cascade recipes and CasMTRRefine with ``refine``;
* ``qtatt_a`` against the JAX ``qtatt_a`` at 2 and 3 levels, 2 and 8
  heads: messages within 1e-5, and its q/k/v gradients against
  ``jax.vjp`` within 1e-5 of the largest gradient;
* the eval forward with every threshold at 0, at a square and a
  non-square input, with quadtree attention B (the recipe) and A (the
  override ``{"coarse": {"attn_type": "A"}}``): the same valid (b, i, j)
  sets at the 1/8 stage and at the end, keypoints within 1e-3 px,
  confidences and fine offsets within 1e-4 (test_torch_slice.py's
  tolerances); the attention-A model has no merge logits, and
  ``load_jax_variables`` fills it leaf for leaf;
* ``Matcher("quadtree_baseline")`` against the JAX ``Matcher`` on a square
  and a padded request;
* one training step against the JAX package's step and ``jax.grad`` of the
  same composition, traced with flax's BatchNorm in the two-pass batch
  variance that the port computes (``torch_parity.two_pass_batch_norm``):
  loss terms within 1e-5 relative, per-leaf gradients within 1e-4 relative
  (leaf norms floored as in test_torch_train.py), BatchNorm statistics
  within 1e-5.  Against flax's default one-pass variance the gray
  backbone's gradients differ by up to 2.6e-3 and loss_f by 5.4e-5: there
  the JAX package's float32 gradient is the one off its float64 value
  (the port's is within 4e-6 of it); the fixture prints that comparison.

The tolerances were fixed before the first run."""

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
from tests.torch_parity import (configs, jitter,  # noqa: E402
                                port_variables, tiny_baseline_overrides,
                                tiny_indoor_overrides)

RECIPE = "quadtree_baseline"
MSG_ATOL = 1e-5
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
TRAIN_SIZE = 64


def test_build_model_dispatches_like_the_jax_factory():
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.models.casmtr_refine import CasMTRRefine
    from casmtr_tpu_torch.models.loftr import QuadtreeLoFTR
    _, tcfg = configs(tiny_baseline_overrides(), RECIPE)
    assert type(build_model(tcfg.loftr)) is QuadtreeLoFTR
    _, icfg = configs(tiny_indoor_overrides(), "indoor_casmtr_4c_runnable")
    assert type(build_model(icfg.loftr)) is CasMTR
    ov = tiny_indoor_overrides()
    ov["loftr"]["backbone"]["refine_dims"] = [6, 12, 16]
    _, rcfg = configs(ov, "indoor_casmtr_4c")
    assert type(build_model(rcfg.loftr, refine=True)) is CasMTRRefine


# --------------------------------------------------------------------------
# quadtree attention A
# --------------------------------------------------------------------------

QTATT_A_CASES = {"2 levels H=2": ([(8, 8), (4, 4)], [4, 4], 2),
                 "3 levels H=2": ([(16, 12), (8, 6), (4, 3)], [4, 4, 4], 2),
                 "3 levels H=8": ([(16, 12), (8, 6), (4, 3)], [4, 3, 2], 8)}


@pytest.mark.parametrize("case", list(QTATT_A_CASES))
def test_qtatt_a_matches_jax(case):
    """Messages within MSG_ATOL, gradients of q/k/v at every level against
    ``jax.vjp`` within MSG_ATOL of the largest gradient."""
    from casmtr_tpu.ops.quadtree import qtatt_a as jax_qtatt_a
    from casmtr_tpu_torch.ops.quadtree import qtatt_a
    sizes, topks, H = QTATT_A_CASES[case]
    D = 8
    rng = np.random.default_rng(0)
    pyr = [[rng.standard_normal((1, h * w, H, D)).astype(np.float32)
            for h, w in sizes] for _ in range(3)]
    want, vjp = jax.vjp(
        lambda q, k, v: jax_qtatt_a(q, k, v, sizes, topks),
        *[[jnp.asarray(x) for x in lvl] for lvl in pyr])
    ts = [[torch.from_numpy(x).requires_grad_(True) for x in lvl]
          for lvl in pyr]
    got = qtatt_a(*ts, sizes, topks)
    assert got.shape == want.shape == (1, sizes[0][0] * sizes[0][1], H, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=MSG_ATOL)
    g = rng.standard_normal(want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(g))
    got.backward(torch.from_numpy(g))
    for wl, tl, name in zip(want_g, ts, "qkv"):
        for lvl, (w, t) in enumerate(zip(wl, tl)):
            w = np.asarray(w)
            assert np.abs(w).max() > 0, f"{name}{lvl}"
            np.testing.assert_allclose(
                t.grad.numpy(), w, rtol=0,
                atol=MSG_ATOL * max(1.0, float(np.abs(w).max())),
                err_msg=f"d{name} at level {lvl}")


def test_attention_a_has_no_merge_logits():
    from casmtr_tpu_torch.models.transformer import QuadtreeAttention
    a = QuadtreeAttention(16, 2, (4, 4, 4), attn_type="A")
    b = QuadtreeAttention(16, 2, (4, 4, 4), attn_type="B")
    assert set(b.state_dict()) - set(a.state_dict()) == {"py_att.weight"}
    guided = QuadtreeAttention(16, 2, (4, 4, 4), attn_type="Guided")
    assert set(guided.state_dict()) == set(b.state_dict())
    assert guided.py_att.weight.shape == b.py_att.weight.shape == (3,)


# --------------------------------------------------------------------------
# the eval forward and the Matcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("attn_type", ["B", "A"])
@pytest.mark.parametrize("hw", [(128, 128), (96, 128)],
                         ids=["square", "non-square"])
def test_baseline_eval_forward_matches_jax(hw, attn_type):
    from casmtr_tpu.models.loftr import QuadtreeLoFTR as JaxQuadtreeLoFTR
    from casmtr_tpu_torch.models.loftr import QuadtreeLoFTR
    from casmtr_tpu_torch.weights import load_jax_variables
    jcfg, tcfg = configs(tiny_baseline_overrides(zero_thresholds=True,
                                                 attn_type=attn_type),
                         RECIPE)
    img0, img1 = _images(np.random.default_rng(0), 2, *hw)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxQuadtreeLoFTR(jcfg.loftr)
    model = QuadtreeLoFTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    has_merge = any("py_att_weight" in k for k in leaves(variables))
    assert has_merge == (attn_type == "B")
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    assert got.cascades == {}
    _assert_same_matches(_fields(got.coarse.matches),
                         _fields(want.coarse.matches))
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    assert got_f["valid"].sum() > 0
    _assert_same_matches(got_f, want_f)


def test_baseline_matcher_answers_like_jax_matcher():
    """A square request and a 128x64 one that the 128 bucket pads (masks on
    the path), through both Matchers with the same weights."""
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = tiny_baseline_overrides(zero_thresholds=True)
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

def grad_errors(got, want):
    """Per-leaf relative gradient errors, leaf norms floored at 1e-3 of the
    whole gradient's (test_torch_train.py's rule), by leaf."""
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    return {k: float(np.linalg.norm(got[k] - w))
            / max(float(np.linalg.norm(w)), 1e-3 * total)
            for k, w in want.items()}


@pytest.fixture(scope="module")
def step_run():
    """One step of each package from the same jittered variables and
    batch, the coarse threshold at 0: the random model's 1/8 matches then
    include some close enough to their ground truth for the fine loss to
    count them (at the recipe's 0.2 it has none, and loss_f is 0).  The JAX
    step is traced with the two-pass BatchNorm variance; its default
    one-pass step is printed beside it."""
    jcfg, tcfg = configs(tiny_baseline_overrides(train_size=TRAIN_SIZE,
                                                 zero_thresholds=True),
                         RECIPE)
    batch = _pair_batch(size=TRAIN_SIZE)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    run = dict(zip(("jscalars", "jgrads", "jstats"),
                   jax_step(jm, jcfg, variables, batch, two_pass_bn=True)),
               **dict(zip(("tscalars", "tgrads", "tstats"),
                          torch_step(tcfg, variables, like, batch))),
               start=variables["batch_stats"])
    one_pass, one_pass_grads, _ = jax_step(jm, jcfg, variables, batch)
    worst = max(grad_errors(leaves(run["tgrads"]),
                            leaves(one_pass_grads)).values())
    print("against the JAX step with one-pass BatchNorm variance: "
          + ", ".join(f"{k} {abs(float(run['tscalars'][k]) / float(v) - 1):.2e}"
                      for k, v in one_pass.items())
          + f", worst leaf {worst:.2e}")
    return run


def test_baseline_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js) == {"loss", "loss_8c", "loss_f", "grad_norm"}
    for k in ("loss", "loss_8c", "loss_f", "grad_norm"):
        print(f"{k}: relative error {abs(float(ts[k]) / float(js[k]) - 1):.2e}")
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    assert float(ts["loss_f"]) > 0


def test_baseline_train_step_gradients_match_jax(step_run):
    want, got = leaves(step_run["jgrads"]), leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    assert any("py_att_weight" in k for k in want)
    for k, err in grad_errors(got, want).items():
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_RTOL, f"{k}: relative error {err}"


def test_baseline_train_step_batch_stats_match_jax(step_run):
    want, got = leaves(step_run["jstats"]), leaves(step_run["tstats"])
    start = leaves(step_run["start"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"
