"""The PMT-refine model ``CasMTRRefine`` on the published ``indoor_casmtr_4c``
wiring in the port against the JAX package, on the CPU at tiny widths
(``tiny_refine_overrides``: the tiny indoor widths of tests/torch_parity.py
with a ladder of 6 / 12 / 16), with the same jittered weights:

* ``Ladder_4_2`` in train mode, ``bn_fix`` on and off, in RGB and in gray,
  on an input whose gray and RGB differ: maps within 1e-4, BatchNorm
  statistics after the forward within 1e-5;
* the eval forward with every threshold at 0 and the 1/4 double check off,
  at stage 3 with the ladder, at stage 3 with the ``no_lst`` projections
  and at stage 1 (the trunk alone): the same valid (b, i, j) sets at every
  stage, keypoints within 1e-3 px, confidences within 1e-4; the JAX
  variables fill the port's module with no key missing and none unused;
* ``frozen_param_label`` labels the same leaves as the JAX one;
* one training step with the frozen trunk, its 1/4 level carrying the
  learnable keypoint-detector head and the ST detector, against the JAX
  package's step (``frozen_label_fn``) and the gradients it takes
  (test_torch_train.py's tolerances), flax's BatchNorm in the port's
  two-pass variance: loss terms (``loss_4c_det`` among them) within 1e-5
  relative, per-leaf gradients of the trainable leaves within 1e-4
  relative (the trunk's are zero in both; the detector head's nonzero),
  the trunk's parameters and BatchNorm statistics unchanged exactly in
  both packages, the ladder's, the heads' and the detector's statistics
  within 1e-5;
* ``load_into_state`` of a ``quadtree_baseline`` model into the refine
  model against the JAX function on the same trees: the same keys taken
  and left fresh, and equal values.

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
from tests.torch_parity import (configs, flax_like,  # noqa: E402
                                port_variables,
                                tiny_baseline_overrides,
                                tiny_indoor_overrides)

RECIPE = "indoor_casmtr_4c"
MAP_ATOL = 1e-4
STAT_ATOL = 1e-5
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
SIZE = 64
TRUNK = ("['backbone']", "['loftr_coarse']")
# the step's detector branch: the learnable head and the straight-through
# detector on the 1/4 level
DETECTOR = {"detector": "learnable", "detector_mode": "ST", "grid_size": 4}


def tiny_refine_overrides(train_size: int = SIZE, zero_thresholds=False):
    """``indoor_casmtr_4c`` at the tiny indoor widths (trunk 8 / [8, 12,
    16], gray; 1/8 stack d 16) with a ladder of refine_dims [6, 12, 16]
    (RGB, as the recipe): the 1/4 stack's d 12 is refine_dims[1], as the
    recipe's 128."""
    ov = tiny_indoor_overrides(train_size, zero_thresholds)
    ov["loftr"]["backbone"]["refine_dims"] = [6, 12, 16]
    if zero_thresholds:
        ov["loftr"]["match_cascade"]["double_check"] = [False]
    return ov


def _trunk(key: str) -> bool:
    return key.startswith(TRUNK)


# --------------------------------------------------------------------------
# the ladder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("is_rgb", [True, False], ids=["rgb", "gray"])
@pytest.mark.parametrize("bn_fix", [True, False], ids=["bn_fix", "no_fix"])
def test_ladder_matches_flax(bn_fix, is_rgb):
    from casmtr_tpu.models.backbone.resnet_fpn import Ladder_4_2 as JaxLadder
    from casmtr_tpu_torch.models.backbone.resnet_fpn import Ladder_4_2
    from casmtr_tpu_torch.weights import jax_variables, load_jax_variables
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 48, 3)).astype(np.float32)
    x[..., 2] = 1 - x[..., 1]            # gray and RGB differ
    f4 = rng.standard_normal((2, 8, 12, 12)).astype(np.float32)
    f2 = rng.standard_normal((2, 16, 24, 8)).astype(np.float32)
    jl = JaxLadder((8, 12, 16), (6, 12, 16), is_rgb, bn_fix)
    args = (jnp.asarray(x), [jnp.asarray(f4), jnp.asarray(f2)])
    tl = Ladder_4_2((8, 12, 16), (6, 12, 16), is_rgb, bn_fix)
    variables = port_variables(tl, lambda: jl.init(jax.random.PRNGKey(0),
                                                     *args))
    want, mutated = jax.jit(lambda v: jl.apply(
        v, *args, train=True, mutable=["batch_stats"]))(variables)
    load_jax_variables(tl, variables)
    tl.train()
    got = tl(torch.from_numpy(x).permute(0, 3, 1, 2),
             [torch.from_numpy(f).permute(0, 3, 1, 2) for f in (f4, f2)])
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), w,
                                   rtol=0, atol=MAP_ATOL * np.abs(w).max())
    stats = leaves(jax_variables(tl.state_dict(), {
        "batch_stats": variables["batch_stats"]})["batch_stats"])
    for k, w in leaves(mutated["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], w, rtol=0, atol=STAT_ATOL,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the eval forward and the weights
# --------------------------------------------------------------------------

EVAL_CASES = {"stage 3 ladder": {},
              "stage 3 no_lst": {"backbone": {"no_lst": True}},
              "stage 1": {"training_stage": 1}}


@pytest.fixture(scope="module", params=list(EVAL_CASES))
def eval_run(request):
    """Both packages' eval forward of the refine model from the same
    jittered variables, on a square pair."""
    from casmtr_tpu.models.casmtr_refine import CasMTRRefine as JaxRefine
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = tiny_refine_overrides(zero_thresholds=True)
    for k, v in EVAL_CASES[request.param].items():
        if isinstance(v, dict):
            ov["loftr"][k].update(v)
        else:
            ov["loftr"][k] = v
    jcfg, tcfg = configs(ov, RECIPE)
    img0, img1 = _images(np.random.default_rng(0), 1, SIZE, SIZE)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxRefine(jcfg.loftr)
    model = build_model(tcfg.loftr, refine=True)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    return dict(case=request.param, variables=variables, model=model,
                got=got, want=want)


def test_refine_eval_forward_stages_match_jax(eval_run):
    got, want = eval_run["got"], eval_run["want"]
    _assert_same_matches(_fields(got.coarse.matches),
                         _fields(want.coarse.matches))
    np.testing.assert_allclose(got.coarse.conf_matrix.numpy(),
                               np.asarray(want.coarse.conf_matrix), rtol=0,
                               atol=CONF_ATOL)
    assert got.cascades.keys() == want.cascades.keys()
    if eval_run["case"] == "stage 1":
        assert got.fine is None and want.fine is None
        return
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


def test_refine_weights_carry_over_with_nothing_missing_or_unused(eval_run):
    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    keys = {flax_path_to_torch_key(tuple(str(getattr(p, "key", p))
                                         for p in path[1:-1]),
                                   path[-1].key)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                eval_run["variables"])[0]}
    own = {k for k in eval_run["model"].state_dict()
           if not k.endswith("num_batches_tracked")}
    assert own - keys == set() and keys - own == set()
    heads = {k.split(".")[0] for k in own}
    want = {"backbone", "loftr_coarse"}
    if eval_run["case"] != "stage 1":
        want |= {"up_block1", "loftr_coarse_4c", "cas_fine_preprocess",
                 "cas_loftr_fine",
                 *(("proj4c", "projf") if "no_lst" in eval_run["case"]
                   else ("ladder",))}
    assert heads == want


def test_frozen_param_label_matches_jax(eval_run):
    from casmtr_tpu.models.casmtr_refine import \
        frozen_param_label as jax_label
    from casmtr_tpu_torch.models.casmtr_refine import frozen_param_label
    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    params = eval_run["variables"]["params"]
    n_frozen = 0
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = flax_path_to_torch_key(tuple(p.key for p in path[:-1]),
                                      path[-1].key)
        assert frozen_param_label(name) == jax_label(path), name
        n_frozen += jax_label(path)
    assert 0 < n_frozen == sum(
        frozen_param_label(n) for n, _ in
        eval_run["model"].named_parameters())


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_run():
    """One refine step of each package from the same jittered variables and
    batch, the trunk frozen in both (the 1/4 double check off, and the
    identity pair, as the indoor step test, so that the tiny random model
    keeps 1/4 matches inside the fine windows).  Its 1/4 level also
    carries the learnable detector head and the ST detector (DETECTOR):
    one compiled JAX step then holds both the refine model and the
    detector branch in a training step (a second tiny-model step would
    double this file's time)."""
    from casmtr_tpu.models.casmtr_refine import \
        frozen_param_label as jax_label
    ov = tiny_refine_overrides()
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    ov["loftr"]["coarse2"].update(DETECTOR)
    # no warm-up: the recipe's starts at a learning rate of 0, and then
    # no parameter would move
    ov["trainer"] = {"warmup_step": 0}
    jcfg, tcfg = configs(ov, RECIPE)
    batch = _pair_batch(size=SIZE, shift=0)
    jm, like, variables = step_variables(jcfg, tcfg, batch, refine=True)
    run = dict(zip(("jscalars", "jgrads", "jstats", "jparams"),
                   jax_step(jm, jcfg, variables, batch, two_pass_bn=True,
                            frozen_label_fn=jax_label, with_params=True)))
    run.update(zip(("tscalars", "tgrads", "tstats", "tparams"),
                   torch_step(tcfg, variables, like, batch, refine=True,
                              with_params=True)))
    return dict(run, start=variables)


def test_refine_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js)
    for k in ("loss", "loss_8c", "loss_4c", "loss_4c_det", "loss_f",
              "grad_norm"):
        rel = abs(float(ts[k]) / float(js[k]) - 1)
        print(f"{k}: relative error {rel:.2e}")
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    assert int(ts["valid_n_4c"]) == int(js["valid_n_4c"]) > 0
    assert float(ts["loss_4c"]) > 0 and float(ts["loss_f"]) > 0


def test_refine_train_step_trains_the_detector_like_jax(step_run):
    """The detector branch inside the step: its loss term carries, its
    head takes a gradient and its BatchNorm statistics move, in both
    packages (their values are held by the tests around this one)."""
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert float(js["loss_4c_det"]) > 0 and float(ts["loss_4c_det"]) > 0
    grads = leaves(step_run["tgrads"])
    want = leaves(step_run["jgrads"])
    head = [k for k in want if "detector_" in k]
    assert len(head) == 6
    # the first conv's bias feeds a training-mode BatchNorm, which removes
    # any per-channel shift: its gradient vanishes analytically
    for k in head:
        if "['detector_0']['bias']" not in k:
            assert np.abs(want[k]).max() > 0, k
            assert np.abs(grads[k]).max() > 0, k
    start = leaves(step_run["start"]["batch_stats"])
    for side in ("jstats", "tstats"):
        stats = leaves(step_run[side])
        moved = [k for k in stats if "detector_1" in k
                 and not np.array_equal(stats[k], start[k])]
        assert len(moved) == 2, side


def test_refine_train_step_gradients_match_jax(step_run):
    want, got = leaves(step_run["jgrads"]), leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    for k in want:
        if _trunk(k):
            assert not np.any(want[k]) and not np.any(got[k]), k
    live = {k: v for k, v in got.items() if not _trunk(k)}
    assert any("['ladder']" in k and np.abs(want[k]).max() > 0 for k in live)
    for k, err in grad_errors(live, {k: want[k] for k in live}).items():
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_RTOL, f"{k}: relative error {err}"


def test_refine_train_step_keeps_the_trunk_exactly(step_run):
    start_p = leaves(step_run["start"]["params"])
    start_s = leaves(step_run["start"]["batch_stats"])
    moved_by = {}
    for side in ("j", "t"):
        params = leaves(step_run[f"{side}params"])
        stats = leaves(step_run[f"{side}stats"])
        assert any(_trunk(k) for k in params)
        moved = {k for k, v in params.items()
                 if not np.array_equal(v, start_p[k])}
        assert moved and not any(_trunk(k) for k in moved)
        moved_by[side] = moved
        for k in params:
            if _trunk(k):
                np.testing.assert_array_equal(params[k], start_p[k],
                                              err_msg=k)
        for k, v in stats.items():
            if _trunk(k):
                np.testing.assert_array_equal(v, start_s[k], err_msg=k)
    assert moved_by["j"] == moved_by["t"]


def test_refine_train_step_batch_stats_match_jax(step_run):
    want, got = leaves(step_run["jstats"]), leaves(step_run["tstats"])
    start = leaves(step_run["start"]["batch_stats"])
    assert got.keys() == want.keys()
    assert any("['ladder']" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert np.array_equal(w, start[k]) == _trunk(k), k


# --------------------------------------------------------------------------
# the trunk checkpoint
# --------------------------------------------------------------------------

def test_load_into_state_matches_jax():
    """A quadtree_baseline model (ResNetFPN_8_2 trunk, its own fine heads)
    merged into a fresh refine model (ResNetFPN_8_4_2 trunk, ladder,
    ``cas_`` heads) by both packages' load_into_state, from the same
    trees."""
    from casmtr_tpu.train.checkpoints import load_into_state as jax_load
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.checkpoints import load_into_state
    from casmtr_tpu_torch.weights import init_random_, jax_variables
    bcfg = configs(tiny_baseline_overrides(SIZE), "quadtree_baseline")[1]
    rcfg = configs(tiny_refine_overrides(), RECIPE)[1]
    base = build_model(bcfg.loftr)
    init_random_(base, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for t in base.state_dict().values():
            if t.is_floating_point():
                t.add_(0.5)
    fresh = build_model(rcfg.loftr, refine=True)
    init_random_(fresh, torch.Generator().manual_seed(4))
    # the flax trees of both: the port's tensors laid out as the JAX
    # package's variables (the weight tests hold that layout)
    blike, rlike = _like(False), _like(True)
    jb = jax_variables(base.state_dict(), blike)
    jr = jax_variables(fresh.state_dict(), rlike)
    merged = {c: jax_load(jb[c], jr[c]) for c in ("params", "batch_stats")}
    report = load_into_state(base.state_dict(), fresh)
    got = leaves(jax_variables(fresh.state_dict(), rlike))
    start, base_l = leaves(jr), leaves(jb)
    want = leaves(merged)
    taken = {k for k in want if k in base_l
             and base_l[k].shape == want[k].shape}
    assert taken and any("['backbone']" in k for k in taken)
    assert all(k.startswith(("['params']['backbone']",
                             "['params']['loftr_coarse']",
                             "['batch_stats']['backbone']")) for k in taken)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        np.testing.assert_array_equal(w, base_l[k] if k in taken
                                      else start[k], err_msg=k)
    nbt = "num_batches_tracked"
    took = {k for k in report["taken"] if not k.endswith(nbt)}
    assert len(took) == len(taken)
    assert not any(k.startswith(("ladder.", "cas_", "up_block1.",
                                 "loftr_coarse_4c.")) for k in took)
    assert {k.split(".")[0] for k in report["unused"]} == {
        "fine_preprocess", "loftr_fine"}
    assert set(report["fresh"]).isdisjoint(report["taken"])


def _like(refine):
    """The zero-filled flax tree of the JAX model of the tiny refine
    recipe (``refine``) or of the tiny ``quadtree_baseline``."""
    from casmtr_tpu.models import build_model as jax_build_model
    jcfg = configs(tiny_refine_overrides() if refine
                   else tiny_baseline_overrides(SIZE),
                   RECIPE if refine else "quadtree_baseline")[0]
    jm = jax_build_model(jcfg.loftr, refine=refine)
    batch = {k: jnp.zeros((1, SIZE, SIZE, 3)) for k in ("image0", "image1")}
    return flax_like(lambda: jm.init(jax.random.PRNGKey(0), batch))
