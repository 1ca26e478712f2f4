"""Checkpoints, weight conversion and the stage-aware resume of the port
against the JAX package, on the CPU at the tiny configurations
(tests/torch_parity.py):

* the port's tiny 2c ``state_dict`` under ``matcher.``, saved as a
  ``.ckpt``, goes through the JAX package's ``convert_state_dict(strict=
  True)`` with nothing missing or unused, the same numbers, and the JAX
  forward on them matches the port's forward from the same file as
  test_torch_2c.py's;
* the reverse: a reference-format ``.ckpt`` written from flax variables
  (``torch_parity.flax_to_torch_sd``) serves through the JAX ``Matcher(
  ckpt=...)`` and the port's with the same matches (test_torch_2c.py's
  tolerances), parameters and BatchNorm statistics loaded exactly;
* the port's ``cli.convert`` of that file gives a directory whose
  ``Matcher`` equals the file's exactly;
* the loader's refusals (a missing key under ``strict``, a wrong shape, an
  orbax directory) and its one named layout exception;
* ``CheckpointManager`` keep-best-plus-last, as the JAX package's;
* ``set_schedule_step`` and ``resume_state`` against the JAX package's on
  the same restored numbers: per-parameter labels, which resumes keep the
  optimizer state, the moments, counts and EMA after the resume, and five
  updates from the same gradients (the learning rate of every group),
  with and without ``reset_lr`` and an old ``config.json``, and a refine
  resume that keeps the trunk frozen.

The JAX side reads the restored optimizer state in the form
``flax.serialization.to_state_dict`` gives; the JAX train CLI's orbax
restore returns its tuples as lists, which its ``from_state_dict`` refuses,
so through that CLI every resume starts with a fresh optimizer state
(ROADMAP.md, section C)."""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_refine import tiny_refine_overrides  # noqa: E402
from tests.test_torch_slice import (_assert_same_matches, _fields,  # noqa
                                    _images)
from casmtr_tpu_torch.weights import jax_variables  # noqa: E402
from tests.torch_parity import (configs, flax_like,  # noqa: E402
                                flax_to_torch_sd, port_variables,
                                tiny_2c_overrides, tiny_4c_overrides)

PX_ATOL = 1e-3
CONF_ATOL = 1e-4
OPT_TOL = 1e-6      # parameters after updates, as test_torch_train.py's
SIZE = 128


def _flat(tree, path=()):
    """{torch key: (leaf name, array)} of a flax tree."""
    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[flax_path_to_torch_key(path, k)] = (k, np.asarray(v))
    return out


def _jax_init(jcfg, refine=False, size=64):
    from casmtr_tpu.models import build_model
    jm = build_model(jcfg.loftr, refine=refine) if refine else \
        build_model(jcfg.loftr)
    b = {k: jnp.zeros((1, size, size, 3), jnp.float32)
         for k in ("image0", "image1")}
    return jm, lambda: jm.init(jax.random.PRNGKey(0), b, train=False)


def _assert_state_dict_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# --------------------------------------------------------------------------
# the port's state dict through the JAX package's conversion
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_file(tmp_path_factory):
    """The port's tiny 2c (thresholds at 0) with jittered weights, its
    ``state_dict`` saved under ``matcher.`` as a reference ``.ckpt``."""
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    jcfg, tcfg = configs(tiny_2c_overrides(zero_thresholds=True),
                         "outdoor_casmtr_2c")
    jm, init = _jax_init(jcfg)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, init, seed=3)
    load_jax_variables(model, variables)
    path = str(tmp_path_factory.mktemp("port") / "port.ckpt")
    torch.save({"state_dict": {"matcher." + k: v
                               for k, v in model.state_dict().items()}},
               path)
    return jcfg, tcfg, jm, init, variables, model.state_dict(), path


def test_port_state_dict_converts_strictly_in_jax(port_file):
    from casmtr_tpu.utils.convert import (convert_state_dict,
                                          load_torch_checkpoint)
    jcfg, _, _, init, variables, _, path = port_file
    converted, report = convert_state_dict(load_torch_checkpoint(path),
                                           flax_like(init), strict=True)
    assert report == {"missing": [], "unused": []}
    got, want = _flat(converted), _flat(variables)
    assert got.keys() == want.keys()
    for k, (_, w) in want.items():
        np.testing.assert_array_equal(got[k][1], w, err_msg=k)


def test_jax_forward_on_the_port_file_matches_the_port(port_file):
    """The JAX forward on the file's conversion against the port's forward
    after ``load_checkpoint_variables`` of the same file into a model of
    other seeded weights, which must then hold the file's tensors exactly
    (BatchNorm statistics included)."""
    from casmtr_tpu.utils.convert import (convert_state_dict,
                                          load_torch_checkpoint)
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.train.checkpoints import load_checkpoint_variables
    from casmtr_tpu_torch.weights import init_random_
    _, tcfg, jm, init, _, saved, path = port_file
    converted, _ = convert_state_dict(load_torch_checkpoint(path),
                                      flax_like(init))
    img0, img1 = _images(np.random.default_rng(0), 2, SIZE, SIZE)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        converted, {"image0": jnp.asarray(img0),
                    "image1": jnp.asarray(img1)})
    model = CasMTR(tcfg.loftr)
    init_random_(model, torch.Generator().manual_seed(9))
    report = load_checkpoint_variables(path, model)
    assert report == {"missing": [], "unused": []}
    _assert_state_dict_equal(model.state_dict(), saved)
    model.eval()
    with torch.inference_mode():
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    for n in ("4c", "2c"):
        np.testing.assert_allclose(got.cascades[n].conf_matrix.numpy(),
                                   np.asarray(want.cascades[n].conf_matrix),
                                   rtol=0, atol=CONF_ATOL)
    stages = [(got.coarse.matches, want.coarse.matches)] + [
        (got.cascades[n].matches, want.cascades[n].matches)
        for n in ("4c", "2c")]
    for g, w in stages:
        g, w = _fields(g), _fields(w)
        assert g["valid"].sum() > 0
        _assert_same_matches(g, w)
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    _assert_same_matches(got_f, want_f)


# --------------------------------------------------------------------------
# a reference-format file from flax variables, served by both Matchers
# --------------------------------------------------------------------------

MATCHER_OV = tiny_4c_overrides(zero_thresholds=True)


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """Jittered tiny-4c flax variables written as a reference ``.ckpt``
    (``flax_to_torch_sd``: the 1/8 stack's q/k/v, Dense in the JAX
    package, come out as the reference's 1x1 convs [O, I, 1, 1])."""
    from casmtr_tpu_torch.models.casmtr import CasMTR
    jcfg, tcfg = configs(MATCHER_OV)
    _, init = _jax_init(jcfg)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, init, seed=4)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sd = flax_to_torch_sd(variables["params"], shapes)
    sd.update(flax_to_torch_sd(variables["batch_stats"], shapes))
    assert any(k.endswith("attn.q_proj.weight") and v.ndim == 4
               for k, v in sd.items())
    path = str(tmp_path_factory.mktemp("ref") / "released.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return variables, path


def _port_matcher(ckpt):
    from casmtr_tpu_torch.serving import Matcher
    return Matcher("outdoor_casmtr_4c", ckpt=ckpt, bucket=SIZE, df=32,
                   thr=0.0, overrides=MATCHER_OV, device="cpu")


def _requests():
    rng = np.random.default_rng(1)
    a0, a1 = _images(rng, 1, SIZE, SIZE)
    b0, b1 = _images(rng, 1, SIZE, 64)
    return ((a0[0], a1[0]), (b0[0], b1[0]))


def test_reference_file_serves_like_the_jax_matcher(reference_file):
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    variables, path = reference_file
    jmatch = JaxMatcher("outdoor_casmtr_4c", ckpt=path, bucket=SIZE, df=32,
                        thr=0.0, overrides=MATCHER_OV)
    tmatch = _port_matcher(path)
    want_sd = CasMTR(configs(MATCHER_OV)[1].loftr)
    load_jax_variables(want_sd, variables)
    got_sd = tmatch.model.state_dict()
    for k, v in want_sd.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got_sd[k], v), k
    for img0, img1 in _requests():
        want = jmatch.match(img0, img1)
        got = tmatch.match(img0, img1)
        assert len(want.mconf) > 0
        assert len(got.mconf) == len(want.mconf)
        og, ow = np.lexsort(got.mkpts0.T), np.lexsort(want.mkpts0.T)
        for name, atol in (("mkpts0", PX_ATOL), ("mkpts1", PX_ATOL),
                           ("mconf", CONF_ATOL)):
            np.testing.assert_allclose(getattr(got, name)[og],
                                       getattr(want, name)[ow], rtol=0,
                                       atol=atol, err_msg=name)


def test_cli_convert_directory_serves_like_the_file(reference_file,
                                                    tmp_path):
    from casmtr_tpu_torch.cli import convert
    from casmtr_tpu_torch.config import load
    _, path = reference_file
    out = str(tmp_path / "converted")
    assert convert.main([path, out, "--model", "outdoor_casmtr_4c",
                         "--overrides-json", json.dumps(MATCHER_OV),
                         "--strict"]) == 0
    assert load(os.path.join(out, "config.json")).loftr.coarse.d_model == 16
    from_file, from_dir = _port_matcher(path), _port_matcher(out)
    _assert_state_dict_equal(from_dir.model.state_dict(),
                             from_file.model.state_dict())
    for img0, img1 in _requests():
        a, b = from_file.match(img0, img1), from_dir.match(img0, img1)
        assert len(a.mconf) > 0
        for name in ("mkpts0", "mkpts1", "mconf"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))


def test_the_loader_refuses_what_does_not_fit(reference_file, tmp_path):
    """Strict conversion raises KeyError on a missing key and ValueError on
    a tensor of another shape (a 1x1 conv as [O, I] too), leaving the
    module as it was; an orbax directory is refused with the port's route
    for JAX weights."""
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.train.checkpoints import load_checkpoint_variables
    from casmtr_tpu_torch.utils.convert import (convert_state_dict,
                                                load_torch_checkpoint)
    _, path = reference_file
    sd = load_torch_checkpoint(path)
    model = CasMTR(configs(MATCHER_OV)[1].loftr)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gone = "matcher.up_block1.up.1.running_var"
    with pytest.raises(KeyError, match="up_block1.up.1.running_var"):
        convert_state_dict({k: v for k, v in sd.items() if k != gone}, model)
    report = convert_state_dict({k: v for k, v in sd.items() if k != gone},
                                CasMTR(configs(MATCHER_OV)[1].loftr),
                                strict=False)
    assert report == {"missing": ["up_block1.up.1.running_var"],
                      "unused": []}
    for key, bad in (
            # a Linear weight of the 1/4 stack offered as a 1x1 conv
            ("matcher.loftr_coarse_4c.layers.0.attn.q_proj.weight",
             lambda v: v[:, :, None, None]),
            # a conv weight transposed
            ("matcher.up_block1.inner.0.weight", lambda v: v.transpose(0, 1)),
            ("matcher.backbone.layer1_outconv.weight",
             lambda v: v[:, :, 0, 0]),
            # the quadtree q/k/v, Dense in the JAX package, as [O, I]
            ("matcher.loftr_coarse_8c.layers.0.attn.q_proj.weight",
             lambda v: v[:, :, 0, 0])):
        if key not in sd:
            key = next(k for k in sd if k.endswith("outconv.0.weight")
                       or k.endswith("outconv.weight"))
        with pytest.raises(ValueError, match=key[len("matcher."):]):
            convert_state_dict(dict(sd, **{key: bad(sd[key])}), model)
    _assert_state_dict_equal(model.state_dict(), before)
    extra = dict(sd, **{"matcher.head.weight": torch.zeros(2),
                        "matcher.backbone.bn.num_batches_tracked":
                            torch.tensor(3)})
    assert convert_state_dict(extra, model)["unused"] == ["head.weight"]
    orbax = tmp_path / "orbax"
    (orbax / "0" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="load_jax_variables"):
        load_checkpoint_variables(str(orbax), model)
    with pytest.raises(FileNotFoundError):
        load_checkpoint_variables(str(tmp_path / "nothing"), model)


# --------------------------------------------------------------------------
# the checkpoint manager
# --------------------------------------------------------------------------

def test_checkpoint_manager_keeps_best_and_last(tmp_path):
    """The port's counterpart of test_train_cli.py's keep-latest test, on
    the same sequence as the JAX package's orbax managers: the best two by
    auc@10 and the newest survive, ``restore()`` takes the newest, a step
    restores by number, a step without the metric counts as -1.0."""
    from casmtr_tpu.train.checkpoints import \
        CheckpointManager as JaxCheckpointManager
    from casmtr_tpu_torch.train.checkpoints import CheckpointManager
    seq = [(10, 0.9), (20, 0.8), (30, 0.1), (40, None)]
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step, auc in seq:
        metrics = {} if auc is None else {"auc@10": auc}
        jmgr.save(step, {"params": {"w": np.full(2, float(step))}}, metrics)
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step},
                 metrics)
    assert mgr.latest_step() == jmgr.latest_step() == 40
    assert mgr.best_step() == jmgr.best_step() == 10
    assert mgr.best_dir.steps() == sorted(jmgr.mgr.all_steps()) == [10, 20]
    assert mgr.last_dir.steps() == list(jmgr.last_mgr.all_steps()) == [40]
    again = CheckpointManager(str(tmp_path / "ck"))
    r = again.restore()
    assert r["step"] == 40 and torch.equal(r["w"], torch.full((2,), 40.0))
    assert again.restore(step=10)["step"] == 10
    assert again.restore(step=30) is None
    assert sorted(os.listdir(tmp_path / "ck")) == ["10.pt", "20.pt",
                                                   "metrics.json"]


# --------------------------------------------------------------------------
# set_schedule_step and resume_state
# --------------------------------------------------------------------------

TRAIN_OV = {"ema": True, "warmup_step": 6, "warmup_ratio": 0.1,
            "warmup_step_stages": 4, "warmup_ratio_stages": 0.1,
            "mslr_milestones": [2, 3], "mslr_gamma": 0.5}
# a checkpointed run's own trainer settings (its config.json)
OLD_TRAIN_OV = dict(TRAIN_OV, canonical_lr=4e-3, canonical_bs=32,
                    warmup_step_stages=2)
BASE_LR, SPE, RSTEP, N_STEPS = 1e-3, 4, 7, 5


def test_set_schedule_step_moves_only_the_schedule_counter():
    """After 3 updates, ``set_schedule_step(state, 7)``: every optax
    ScaleByScheduleState count reads 7 and every ScaleByAdamState count
    still 3; the port's ``schedule_count`` 7 and ``count`` 3."""
    import optax

    from casmtr_tpu.train import optim as jopt
    from casmtr_tpu_torch.train import optim as topt
    jcfg, tcfg = configs({"trainer": TRAIN_OV})
    p = {"backbone": {"w": jnp.ones(3)}, "head": {"w": jnp.ones(2)}}
    tx = jopt.build_optimizer(jcfg.trainer, BASE_LR, SPE,
                              new_param_labels=jopt.new_stage_labels(p))
    js = tx.init(p)
    tp = {"backbone.w": torch.ones(3), "head.w": torch.ones(2)}
    ttx = topt.build_optimizer(tcfg.trainer, BASE_LR, SPE,
                               new_param_labels=topt.new_stage_labels(tp))
    ts = ttx.init(tp)
    for _ in range(3):
        _, js = tx.update(jax.tree_util.tree_map(jnp.ones_like, p), js, p)
        ttx.update(tp, {n: torch.ones_like(v) for n, v in tp.items()}, ts)
    js = jopt.set_schedule_step(js, RSTEP)
    ts = topt.set_schedule_step(ts, RSTEP)

    def counts(kind):
        return {int(x.count) for x in jax.tree_util.tree_leaves(
            js, is_leaf=lambda x: isinstance(x, kind))
            if isinstance(x, kind)}

    assert counts(optax.ScaleByScheduleState) == {RSTEP}
    assert counts(optax.ScaleByAdamState) == {3}
    assert (ts.schedule_count, ts.count) == (RSTEP, 3)


# case: (source model, source labels, target model, expected to keep the
# optimizer state as the JAX package does).  A model is (recipe stage,
# refine); labels "stage" are new_stage_labels' (a run that itself resumed
# at stage > 1), None a fresh start's (init_train_state).
RESUME_CASES = {
    "stage 1 -> 1": ((1, False), None, (1, False), True),
    "stage 2 fresh start -> 2": ((2, False), None, (2, False), False),
    "stage 3 resumed -> 3": ((3, False), "stage", (3, False), True),
    "stage 1 -> 2": ((1, False), None, (2, False), False),
    "stage 2 -> 3": ((2, False), "stage", (3, False), False),
    "refine resumed -> refine": ((3, True), "stage", (3, True), True),
}
# (reset_lr, an old config.json beside the checkpoints, global_bs)
LR_CASES = {"reset_lr": (True, True, None),
            "old config": (False, True, None),
            "old config, global_bs": (False, True, 8),
            "no old config": (False, False, None)}
RUNS = [(c, "reset_lr") for c in RESUME_CASES] + [
    ("stage 3 resumed -> 3", lr) for lr in LR_CASES if lr != "reset_lr"]


def _model_cfg(stage, refine):
    ov = tiny_refine_overrides() if refine else tiny_2c_overrides()
    ov["loftr"]["training_stage"] = stage
    ov["trainer"] = dict(TRAIN_OV)
    recipe = "indoor_casmtr_4c" if refine else "outdoor_casmtr_2c"
    return configs(ov, recipe)


@functools.lru_cache(maxsize=None)
def _like(stage, refine):
    """The zero flax variables of the JAX model at ``stage``."""
    return flax_like(_jax_init(_model_cfg(stage, refine)[0], refine)[1])


def _frozen(refine):
    if not refine:
        return None, None
    from casmtr_tpu.models.casmtr_refine import \
        frozen_param_label as jax_frozen
    from casmtr_tpu_torch.models.casmtr_refine import frozen_param_label
    return jax_frozen, frozen_param_label


def _port_model(tcfg, refine, seed):
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.weights import init_random_
    model = build_model(tcfg.loftr, refine=refine)
    init_random_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():     # no BatchNorm statistic at its initial value
        gen = torch.Generator().manual_seed(seed + 100)
        for k, t in model.state_dict().items():
            if t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=gen).abs())
    return model


def _port_source(case, seed=1):
    """A port checkpoint of the source run: its model's weights, moments,
    counts and EMA parameters made from ``seed``."""
    from casmtr_tpu_torch.train import optim as topt
    (stage, refine), labels, _, _ = RESUME_CASES[case]
    _, tcfg = _model_cfg(stage, refine)
    model = _port_model(tcfg, refine, seed)
    params = dict(model.named_parameters())
    tx = topt.build_optimizer(
        tcfg.trainer, BASE_LR, SPE,
        new_param_labels=(topt.new_stage_labels(params)
                          if labels else None),
        restore_step=RSTEP if labels else 0,
        frozen_label_fn=_frozen(refine)[1])
    opt = tx.init(params)
    gen = torch.Generator().manual_seed(seed + 200)
    for n in opt.mu:
        opt.mu[n] = 1e-3 * torch.randn(opt.mu[n].shape, generator=gen)
        opt.nu[n] = 1e-6 * torch.rand(opt.nu[n].shape, generator=gen)
    return {"state_dict": {k: v.clone() for k, v in
                           model.state_dict().items()},
            "opt_state": {"mu": opt.mu, "nu": opt.nu, "count": 5,
                          "schedule_count": RSTEP,
                          "labels": dict(opt.labels)},
            "step": RSTEP,
            "ema_params": {n: p.detach() + 0.01 for n, p in params.items()}}


def _jax_labels(flax_params, stage, jax_frozen):
    """Each parameter's group as the JAX package's optimizer labels it (its
    ``label_fn``: frozen, then ViT, then new_stage_labels' 'new'), by torch
    key."""
    from casmtr_tpu.train.optim import _is_vit_path, new_stage_labels
    new = _flat(new_stage_labels(flax_params)) if stage > 1 else {}

    def label(path, _):
        if jax_frozen is not None and jax_frozen(path):
            return "frozen"
        if _is_vit_path(path):
            return "vit"
        return "new" if new and new_key(path) == "new" else "main"

    def new_key(path):
        from casmtr_tpu_torch.weights import flax_path_to_torch_key
        keys = [str(getattr(k, "key", k)) for k in path]
        return new[flax_path_to_torch_key(tuple(keys[:-1]), keys[-1])][1]

    return {k: str(v) for k, (_, v) in _flat(jax.tree_util.tree_map_with_path(
        label, flax_params)).items()}


def _jax_source_opt_state(restored, flax_params, stage_labels, jax_frozen,
                          jcfg):
    """The source run's optax state, its Adam moments and counts filled
    with the port checkpoint's numbers, as ``to_state_dict`` lays it out."""
    from flax import serialization

    from casmtr_tpu.train import optim as jopt
    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    tx = jopt.build_optimizer(
        jcfg.trainer, BASE_LR, SPE,
        new_param_labels=(jopt.new_stage_labels(flax_params)
                          if stage_labels else None),
        restore_step=RSTEP if stage_labels else 0,
        frozen_label_fn=jax_frozen)
    like = _flat(flax_params)
    opt = restored["opt_state"]

    def fill(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "name", getattr(
            k, "idx", k)))) for k in path]
        for moment in ("mu", "nu"):
            if moment in names:
                rest = names[names.index(moment) + 1:]
                key = flax_path_to_torch_key(tuple(rest[:-1]), rest[-1])
                return jnp.asarray(_flax_layout(opt[moment][key].numpy(),
                                                like[key]))
        if names and names[-1] == "count":
            return jnp.asarray(opt["count"], jnp.int32)
        return leaf

    state = jax.tree_util.tree_map_with_path(fill, tx.init(flax_params))
    return serialization.to_state_dict(state)


def _flax_layout(t, like):
    """A torch tensor's numpy value in the layout of the flax leaf
    ``like`` = (leaf name, array)."""
    from casmtr_tpu_torch.weights import _from_torch_layout
    return _from_torch_layout(t, like[1], like[0], "moment")


def _jax_moments(opt_state):
    """{torch key: (mu, nu)} and the Adam and schedule counts of an optax
    state of the JAX package's optimizer."""
    import optax

    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    mu, nu, adam, sched = {}, {}, set(), set()
    for x in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(
            x, (optax.ScaleByAdamState, optax.ScaleByScheduleState))):
        if isinstance(x, optax.ScaleByScheduleState):
            sched.add(int(x.count))
        if not isinstance(x, optax.ScaleByAdamState):
            continue
        adam.add(int(x.count))
        for store, tree in ((mu, x.mu), (nu, x.nu)):
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
                keys = [str(getattr(k, "key", k)) for k in path]
                store[flax_path_to_torch_key(tuple(keys[:-1]), keys[-1])] = \
                    np.asarray(v)
    return mu, nu, adam, sched


@pytest.mark.parametrize("case,lr_case", RUNS,
                         ids=[f"{c} ({lr})" for c, lr in RUNS])
def test_resume_state_matches_jax(case, lr_case, tmp_path):
    import optax

    from casmtr_tpu.cli.train import resume_state as jax_resume
    from casmtr_tpu.config import dump as jax_dump
    from casmtr_tpu.config import override as jax_override
    from casmtr_tpu.train import optim as jopt
    from casmtr_tpu.train.train_step import TrainState as JaxState
    from casmtr_tpu_torch.cli.train import resume_state
    from casmtr_tpu_torch.train.train_step import init_train_state
    (src_stage, src_refine), stage_labels, (stage, refine), keep = \
        RESUME_CASES[case]
    reset_lr, old_config, global_bs = LR_CASES[lr_case]
    jax_frozen, port_frozen = _frozen(refine)
    restored = _port_source(case)

    # the same restored numbers for the JAX package
    jsrc, _ = _model_cfg(src_stage, src_refine)
    src_like = _like(src_stage, src_refine)
    src_vars = jax_variables(restored["state_dict"], src_like)
    jrestored = {
        "params": src_vars["params"],
        "batch_stats": src_vars.get("batch_stats", {}),
        "opt_state": _jax_source_opt_state(restored, src_vars["params"],
                                           stage_labels, jax_frozen, jsrc),
        "step": np.int64(RSTEP),
        "ema_params": jax_variables(restored["ema_params"],
                               {"params": src_like["params"]})["params"]}

    # the fresh target state of each package, with the same numbers
    jcfg, tcfg = _model_cfg(stage, refine)
    model = _port_model(tcfg, refine, seed=2)
    like = _like(stage, refine)
    fresh = jax_variables(model.state_dict(), like)
    state, _ = init_train_state(model, tcfg, SPE, BASE_LR,
                                frozen_label_fn=port_frozen, device="cpu")
    jtx0 = jopt.build_optimizer(jcfg.trainer, BASE_LR, SPE,
                                frozen_label_fn=jax_frozen)
    jp = jax.tree_util.tree_map(jnp.asarray, fresh["params"])
    jstate = JaxState(jnp.zeros((), jnp.int32), jp,
                      jax.tree_util.tree_map(jnp.asarray,
                                             fresh.get("batch_stats", {})),
                      jtx0.init(jp), jp)

    resume_dir = None
    if old_config:
        jax_dump(jax_override(jcfg, {"trainer": OLD_TRAIN_OV}),
                 str(tmp_path / "config.json"))
        resume_dir = str(tmp_path / "ckpts")
    kw = dict(reset_lr=reset_lr, resume_dir=resume_dir, global_bs=global_bs)
    jstate, jtx, _ = jax_resume(jcfg, jstate, jrestored, BASE_LR, SPE,
                                frozen_label_fn=jax_frozen, **kw)
    state, tx, _ = resume_state(tcfg, state, restored, BASE_LR, SPE,
                                frozen_label_fn=port_frozen, **kw)

    # merged weights, labels, optimizer state and EMA
    assert state.step == int(jstate.step) == RSTEP
    merged = _flat(jax_variables(model.state_dict(), like))
    want = _flat({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert merged.keys() == want.keys()
    for k, (_, w) in want.items():
        np.testing.assert_array_equal(merged[k][1], w, err_msg=k)
    labels = _jax_labels(jstate.params, stage, jax_frozen)
    assert state.opt_state.labels == labels
    assert ("new" in labels.values()) == (stage > 1)
    assert ("frozen" in labels.values()) == refine
    mu, nu, adam, sched = _jax_moments(jstate.opt_state)
    assert set(state.opt_state.mu) == set(mu) == {
        n for n, g in labels.items() if g != "frozen"}
    like_params = _flat(like["params"])
    for n in mu:
        for got_m, want_m in ((state.opt_state.mu, mu),
                              (state.opt_state.nu, nu)):
            np.testing.assert_array_equal(
                _flax_layout(got_m[n].numpy(), like_params[n]), want_m[n],
                err_msg=n)
    kept = any(float(np.abs(v).sum()) > 0 for v in mu.values())
    assert kept == keep
    assert adam == {state.opt_state.count} == {5 if keep else 0}
    assert sched == {state.opt_state.schedule_count} == {RSTEP}
    ema = _flat(jax_variables(state.ema_params, {"params": like["params"]}))
    for k, (_, w) in _flat({"params": jstate.ema_params}).items():
        np.testing.assert_array_equal(ema[k][1], w, err_msg=k)

    # five updates from the same gradients: every group's learning rate
    params = dict(model.named_parameters())
    frozen = {n: p.detach().clone() for n, p in params.items()
              if port_frozen is not None and port_frozen(n)}
    gen = torch.Generator().manual_seed(7)
    jp = jstate.params
    js = jstate.opt_state
    update = jax.jit(jtx.update)
    for i in range(N_STEPS):
        g = {n: (0.02 * (i + 1)) * torch.randn(p.shape, generator=gen)
             for n, p in params.items()}
        jg = jax_variables(g, {"params": like["params"]})["params"]
        upd, js = update(jax.tree_util.tree_map(jnp.asarray, jg), js, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update(params, g, state.opt_state)
    got = _flat(jax_variables(params, {"params": like["params"]}))
    for k, (_, w) in _flat({"params": jp}).items():
        np.testing.assert_allclose(got[k][1], np.asarray(w), rtol=0,
                                   atol=OPT_TOL, err_msg=k)
    assert bool(frozen) == refine
    for n, t in frozen.items():
        assert torch.equal(params[n], t), n
