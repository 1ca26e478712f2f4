"""Staged training of CasMTR-2c in the port against the JAX package, on the
CPU at the tiny 2c configuration (tests/torch_parity.py):

* at ``training_stage`` 1 (the 1/8 stage alone) and 2 (plus the 1/4 level,
  no 1/2 level and no fine stage, as the JAX model builds them): the
  ``state_dict`` keys equal the JAX variables' mapped names; the eval
  forward with every threshold at 0 as test_torch_2c.py's (the same valid
  (b, i, j) sets, keypoints within 1e-3 px, confidences within 1e-4); one
  training step against the JAX package's step and the gradients it takes
  (``step_gradients``) at test_torch_2c.py's tolerances: exactly the
  stage's loss terms, each within 1e-5 relative, per-leaf gradients within
  1e-4 relative, BatchNorm statistics within 1e-5;
* a CPU round trip at stage 1: four steps straight against two steps, a
  checkpoint through ``CheckpointManager``, ``cli.train.resume_state`` into
  a model of other weights, and two more steps: parameters, BatchNorm
  statistics, moments, counts and EMA parameters bit-identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_2c import _step_overrides  # noqa: E402
from tests.test_torch_slice import (_assert_same_matches, _fields,  # noqa
                                    _images)
from tests.test_torch_train import (_leaves, _pair_batch, jax_step,  # noqa
                                    step_variables, torch_step)
from tests.torch_parity import (configs, port_variables,  # noqa: E402
                                tiny_2c_overrides)

RECIPE = "outdoor_casmtr_2c"
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
TRAIN_SIZE = 64
# the modules each stage builds, as the JAX model's variable trees
MODULES = {1: {"backbone", "loftr_coarse_8c"},
           2: {"backbone", "loftr_coarse_8c", "up_block1",
               "loftr_coarse_4c"}}
LOSSES = {1: {"loss", "loss_8c", "grad_norm"},
          2: {"loss", "loss_8c", "loss_4c", "valid_n_4c", "grad_norm"}}


def _staged(overrides, stage):
    overrides["loftr"]["training_stage"] = stage
    return configs(overrides, RECIPE)


# --------------------------------------------------------------------------
# the model at stages 1 and 2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_stage_state_dict_has_the_jax_names(stage):
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    jcfg, tcfg = _staged(tiny_2c_overrides(), stage)
    batch = _pair_batch(size=TRAIN_SIZE)
    _, like, _ = step_variables(jcfg, tcfg, batch)
    names = {flax_path_to_torch_key(
        tuple(str(getattr(k, "key", k)) for k in p[1:-1]),
        str(getattr(p[-1], "key", p[-1])))
        for p, _ in jax.tree_util.tree_flatten_with_path(like)[0]}
    sd = CasMTR(tcfg.loftr).state_dict()
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == names
    assert {k.split(".")[0] for k in sd} == MODULES[stage]


@pytest.fixture(scope="module", params=[1, 2])
def eval_run(request):
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    stage = request.param
    jcfg, tcfg = _staged(tiny_2c_overrides(zero_thresholds=True), stage)
    img0, img1 = _images(np.random.default_rng(0), 2, 128, 128)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxCasMTR(jcfg.loftr)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False), seed=stage)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables,
                                                              batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    return stage, got, want


def test_stage_eval_forward_matches_jax(eval_run):
    stage, got, want = eval_run
    assert set(got.cascades) == set(want.cascades) == (
        {"4c"} if stage == 2 else set())
    assert got.fine is None and want.fine is None
    stages = [(got.coarse.matches, want.coarse.matches)]
    if stage == 2:
        stages.append((got.cascades["4c"].matches,
                       want.cascades["4c"].matches))
        np.testing.assert_allclose(got.cascades["4c"].conf_matrix.numpy(),
                                   np.asarray(want.cascades["4c"].conf_matrix),
                                   rtol=0, atol=1e-4)
    # the last stage's matches are final, with their own keypoints
    stages.append((got.final_matches, want.final_matches))
    for g, w in stages:
        g, w = _fields(g), _fields(w)
        assert g["valid"].sum() > 0
        _assert_same_matches(g, w)
    np.testing.assert_array_equal(
        got.final_matches.i_ids.numpy(),
        (got.cascades["4c"] if stage == 2 else got.coarse).matches.i_ids
        .numpy())


# --------------------------------------------------------------------------
# one training step at stages 1 and 2
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[1, 2])
def step_run(request):
    """One step of each package from the same jittered variables and batch
    (the JAX step jitted once, its gradients from its own trace)."""
    stage = request.param
    jcfg, tcfg = _staged(_step_overrides(), stage)
    batch = _pair_batch(size=TRAIN_SIZE)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    jscalars, jgrads, jstats = jax_step(jm, jcfg, variables, batch)
    tscalars, tgrads, tstats = torch_step(tcfg, variables, like, batch)
    return dict(stage=stage, start=variables["batch_stats"],
                jscalars=jscalars, jgrads=jgrads, jstats=jstats,
                tscalars=tscalars, tgrads=tgrads, tstats=tstats)


def test_stage_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js) == LOSSES[step_run["stage"]]
    for k in ts:
        if not k.startswith("valid_n"):
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=STEP_LOSS_RTOL, err_msg=k)
    if step_run["stage"] == 2:
        assert int(ts["valid_n_4c"]) == int(js["valid_n_4c"]) > 0
        assert float(ts["loss_4c"]) > 0


def test_stage_train_step_gradients_match_jax(step_run):
    want = _leaves(step_run["jgrads"])
    got = _leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    assert total > 0
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * scale, f"{k}: relative error {err / scale}"
    assert any("loftr_coarse_8c" in k and float(np.abs(w).sum()) > 0
               for k, w in want.items())
    if step_run["stage"] == 2:
        assert any("loftr_coarse_4c" in k and float(np.abs(w).sum()) > 0
                   for k, w in want.items())


def test_stage_train_step_batch_stats_match_jax(step_run):
    want = _leaves(step_run["jstats"])
    got = _leaves(step_run["tstats"])
    start = _leaves(step_run["start"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"


# --------------------------------------------------------------------------
# the CPU round trip
# --------------------------------------------------------------------------

def _trainer(tcfg, seed):
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import init_random_
    model = build_model(tcfg.loftr)
    init_random_(model, torch.Generator().manual_seed(seed))
    state, tx = init_train_state(model, tcfg, 4, 1e-3, device="cpu")
    return model, state, tx


def test_resume_round_trip_is_bit_identical(tmp_path):
    from casmtr_tpu_torch.cli.train import resume_state
    from casmtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                                    checkpoint_state)
    from casmtr_tpu_torch.train.train_step import make_train_step
    ov = _step_overrides()
    ov["trainer"] = {"ema": True, "warmup_step": 3, "warmup_ratio": 0.1,
                     "mslr_milestones": [1]}
    _, tcfg = _staged(ov, 1)
    batches = [_pair_batch(size=TRAIN_SIZE, seed=s) for s in range(4)]

    model, straight, tx = _trainer(tcfg, 1)
    step = make_train_step(model, tcfg, tx, device="cpu")
    for b in batches:
        straight, _ = step(straight, b)

    first, state, tx = _trainer(tcfg, 1)
    step = make_train_step(first, tcfg, tx, device="cpu")
    for b in batches[:2]:
        state, _ = step(state, b)
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(state.step, checkpoint_state(state))
    resumed, state, _ = _trainer(tcfg, 5)
    state, tx, _ = resume_state(tcfg, state, mgr.restore(), 1e-3, 4,
                                reset_lr=True)
    assert state.step == 2
    step = make_train_step(resumed, tcfg, tx, device="cpu")
    for b in batches[2:]:
        state, _ = step(state, b)

    a, b = straight, state
    assert a.step == b.step == 4
    assert (a.opt_state.count, a.opt_state.schedule_count) == \
        (b.opt_state.count, b.opt_state.schedule_count) == (4, 4)
    assert a.opt_state.labels == b.opt_state.labels
    for name, x, y in (("state_dict", model.state_dict(),
                        resumed.state_dict()),
                       ("mu", a.opt_state.mu, b.opt_state.mu),
                       ("nu", a.opt_state.nu, b.opt_state.nu),
                       ("ema", a.ema_params, b.ema_params)):
        assert x.keys() == y.keys(), name
        for k in x:
            assert torch.equal(x[k], y[k]), f"{name} {k}"
