"""``cascade_levels`` other than (4,) and (4, 2) in the port against the JAX
package, on the CPU at the tiny 4c and 2c configurations (64^2), with the
same weights:

* the eval forward at (8,) on tiny 4c and at (2, 4) on tiny 2c, every
  threshold at 0: the stages run by position (1/4, then 1/2) whatever the
  values, so the same valid (b, i, j) sets at the 1/8 stage, at each
  cascade stage and at the end, keypoints within 1e-3 px and confidences
  within 1e-4, as test_torch_slice.py;
* the training-mode loss at (2,) on tiny 4c (supervision, forward and
  CascadeLoss, the value only): the step supplies gt_idx_2c, the 1/4 stage
  reads gt_idx_4c and finds none, so both packages give the same loss
  terms (no loss_4c), each within 1e-5 relative; the fine ground truth is
  read at the 1/2 grid, and with fine_correct_thr at FINE_CORRECT_THR
  some selected rows count as correct and feed loss_f, which is then
  above 0;
* the refine model at (8,), which ignores the field in both packages: it
  builds the modules it builds at (4,), and its step's loss terms (no
  loss_4c; loss_f, read at the 1/8 grid, above 0) equal the JAX refine
  model's loss on the same weights and batch, each within 1e-5 relative;
* a fine stack of block_type 'quadtree' is refused by both packages (the
  JAX model fails at init, its FineConfig having no topks; the port says
  so), and an unknown block_type raises ValueError in both.

The (4, 4) training step with its gradients is in
test_torch_cascade_levels_step.py."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_refine import tiny_refine_overrides  # noqa: E402
from tests.test_torch_slice import (_assert_same_matches, _fields,  # noqa
                                    _images)
from tests.test_torch_train import _jnp, _pair_batch  # noqa: E402
from tests.test_torch_train import step_variables, torch_step  # noqa
from tests.torch_parity import (configs, fast_jit, jax_eval,  # noqa: E402
                                port_variables, tiny_2c_overrides,
                                tiny_4c_overrides, tiny_baseline_overrides,
                                two_pass_batch_norm)

SIZE = 64
LOSS_RTOL = 1e-5
# the fine loss counts a row as correct below this offset (in window
# radii); at the recipe's 1.0 no row of the tiny random model is correct at
# (2,) or (4, 4), and loss_f is 0 in both packages whatever index rule reads
# the ground truth.  At 4 (the rows' offsets lie on a 0.5 grid, none near
# 4): at (4, 4) the rows counted are 7 of the 14 selected rows whose 1/2
# index is clamped to the 1/4 grid's end, at (2,) 6 of 16
FINE_CORRECT_THR = 4.0

EVAL_CASES = {"4c at (8,)": ("outdoor_casmtr_4c", tiny_4c_overrides, [8]),
              "2c at (2, 4)": ("outdoor_casmtr_2c", tiny_2c_overrides,
                               [2, 4])}


def _overrides(tiny, levels, **kw):
    ov = tiny(train_size=SIZE, **kw)
    ov["loftr"]["cascade_levels"] = levels
    return ov


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_forward_runs_stages_by_position_as_jax(case):
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    recipe, tiny, levels = EVAL_CASES[case]
    jcfg, tcfg = configs(_overrides(tiny, levels, zero_thresholds=True),
                         recipe)
    img0, img1 = _images(np.random.default_rng(0), 2, SIZE, SIZE)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxCasMTR(jcfg.loftr)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    want = jax_eval(jm, variables, batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})

    names = ["4c", "2c"][:len(levels)]
    assert sorted(got.cascades) == sorted(want.cascades) == sorted(names)
    _assert_same_matches(_fields(got.coarse.matches),
                         _fields(want.coarse.matches))
    for name in names:
        assert got.cascades[name].hw0 == tuple(want.cascades[name].hw0) \
            == (SIZE // (4 if name == "4c" else 2),) * 2
        _assert_same_matches(_fields(got.cascades[name].matches),
                             _fields(want.cascades[name].matches))
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    _assert_same_matches(got_f, want_f)


def _jax_loss(jm, lcfg, variables, batch, two_pass_bn=False):
    """The JAX step's loss function (train_step.make_train_step's
    ``loss_fn`` with the ground truth its ``step_fn`` adds), the value
    only: the scalars, with each cascade stage's valid_n.  ``two_pass_bn``
    traces it with flax's BatchNorm in the port's two-pass variance, as
    the refine step test does."""
    from casmtr_tpu.train import supervision as jspv
    from casmtr_tpu.train.loss import casmtr_loss

    def fn(v, b):
        gt = jspv.compute_supervision(b, lcfg)
        b = dict(b)
        for level in lcfg.cascade_levels:
            b[f"gt_idx_{level}c"] = gt[f"gt_idx_{level}c"]
            b[f"gt_mask_{level}c"] = gt[f"gt_mask_{level}c"]
        out, _ = jm.apply(v, b, train=True, mutable=["batch_stats"])
        expec = None
        if out.fine is not None:
            last = (list(out.cascades.values())[-1] if out.cascades
                    else out.coarse)
            expec = jspv.fine_expec_gt(gt, last.matches, b, lcfg)
        _, scalars = casmtr_loss(out, gt, expec, lcfg)
        scalars = dict(scalars)
        for name, st in out.cascades.items():
            scalars[f"valid_n_{name}"] = jnp.sum(st.matches.valid)
        return scalars

    with (two_pass_batch_norm() if two_pass_bn
          else contextlib.nullcontext()):
        return fast_jit(fn)(variables, batch)


def test_train_loss_at_2_drops_loss_4c_as_jax():
    """At (2,) the 1/4 stage finds no gt_idx_4c: no loss_4c in either
    package, and the fine ground truth is read at the 1/2 grid (the last
    value's), as the JAX step reads it; loss_f is above 0
    (FINE_CORRECT_THR)."""
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import forward_loss, prepare_batch
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = _overrides(tiny_4c_overrides, [2])
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    ov["loftr"]["loss"] = {"fine_correct_thr": FINE_CORRECT_THR}
    jcfg, tcfg = configs(ov)
    batch = _pair_batch(size=SIZE)
    jm, _, variables = step_variables(jcfg, tcfg, batch)
    want = {k: float(v) for k, v in
            _jax_loss(jm, jcfg.loftr, variables, _jnp(batch)).items()}

    model = build_model(tcfg.loftr)
    load_jax_variables(model, variables)
    model.train()
    with torch.no_grad():
        tb, gt = prepare_batch(batch, tcfg.loftr, torch.device("cpu"))
        assert "gt_idx_2c" in tb and "gt_idx_4c" not in tb
        _, scalars = forward_loss(model, tb, gt, tcfg.loftr)
    got = {k: float(v) for k, v in scalars.items()}
    assert set(got) == set(want) == {"loss", "loss_8c", "loss_f",
                                     "valid_n_4c"}
    assert want["loss_8c"] > 0 and want["valid_n_4c"] > 0
    assert want["loss_f"] > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=k)


def test_refine_model_ignores_cascade_levels():
    """The refine model builds at (8,) the modules it builds at (4,), and
    its step (the trunk frozen), which supplies gt_idx_8c where the 1/4
    stage reads gt_idx_4c and reads the fine ground truth at the 1/8 grid,
    gives the JAX refine model's loss terms on the same jittered weights
    and batch: no loss_4c, loss_f above 0, each term within 1e-5
    relative."""
    from casmtr_tpu_torch.configs import build_config
    from casmtr_tpu_torch.models import build_model
    ov = tiny_refine_overrides()
    ov["loftr"]["cascade_levels"] = [8]
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    jcfg, tcfg = configs(ov, "indoor_casmtr_4c")
    standard = build_model(build_config("indoor_casmtr_4c",
                                        overrides=tiny_refine_overrides()
                                        ).loftr, refine=True)
    batch = _pair_batch(size=SIZE, shift=0)
    jm, like, variables = step_variables(jcfg, tcfg, batch, refine=True)
    want = {k: float(v) for k, v in _jax_loss(
        jm, jcfg.loftr, variables, _jnp(batch), two_pass_bn=True).items()}
    scalars, _, _ = torch_step(tcfg, variables, like, batch, refine=True)
    got = {k: float(v) for k, v in scalars.items()}
    assert build_model(tcfg.loftr, refine=True).state_dict().keys() \
        == standard.state_dict().keys()
    assert set(want) == {"loss", "loss_8c", "loss_f", "valid_n_4c"}
    assert set(got) == set(want) | {"grad_norm"}
    assert want["loss_f"] > 0 and want["valid_n_4c"] > 0
    assert np.isfinite(got["grad_norm"])
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=k)


REFUSALS = {"4c fine quadtree": ("outdoor_casmtr_4c", "quadtree"),
            "baseline fine quadtree": ("quadtree_baseline", "quadtree"),
            "4c fine unknown": ("outdoor_casmtr_4c", "performer")}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_both_packages_refuse_the_fine_block(case):
    """The JAX model fails when it is initialized (traced here by
    ``jax.eval_shape``): AttributeError on ``topks`` for 'quadtree',
    ValueError for an unknown block; the port refuses at construction,
    with the JAX package's reason for 'quadtree'."""
    from casmtr_tpu.models import build_model as jax_build_model
    from casmtr_tpu_torch.models import build_model
    recipe, block = REFUSALS[case]
    tiny = (tiny_baseline_overrides if recipe == "quadtree_baseline"
            else tiny_4c_overrides)
    ov = tiny(train_size=SIZE)
    ov["loftr"]["fine"]["block_type"] = block
    jcfg, tcfg = configs(ov, recipe)
    img = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    jm = jax_build_model(jcfg.loftr)
    jax_error = (AttributeError, "topks") if block == "quadtree" else \
        (ValueError, block)
    with pytest.raises(jax_error[0], match=jax_error[1]):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       {"image0": img, "image1": img},
                                       train=False))
    port_error = ((NotImplementedError, "FineConfig has no topks")
                  if block == "quadtree" else (ValueError, block))
    with pytest.raises(port_error[0], match=port_error[1]):
        build_model(tcfg.loftr)


def test_fine_quadtree_builds_where_no_fine_stage_runs():
    """2c at training stage 2 builds no fine stack, so a fine block_type
    of 'quadtree' is never read: both packages build the model."""
    from casmtr_tpu.models import build_model as jax_build_model
    from casmtr_tpu_torch.models import build_model
    ov = tiny_2c_overrides(train_size=SIZE)
    ov["loftr"].update(training_stage=2)
    ov["loftr"]["fine"]["block_type"] = "quadtree"
    jcfg, tcfg = configs(ov, "outdoor_casmtr_2c")
    img = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    jm = jax_build_model(jcfg.loftr)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), {"image0": img, "image1": img}, train=False))
    model = build_model(tcfg.loftr)
    assert "loftr_fine" not in shapes["params"]
    assert not hasattr(model, "loftr_fine")
