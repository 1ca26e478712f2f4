"""The port's training step of CasMTR-4c against the JAX package's, on the CPU
at the tiny 4c configuration (tests/torch_parity.py), piece by piece:

* supervision: ``warp_kpts`` and ``compute_supervision`` give the same
  integer ground truth (with depth holes, padding masks and scales);
* losses: every coarse / cascade / fine loss type within 1e-6, value and
  gradient;
* optimizer: the same gradients fed to the optax chain and to the port for
  6 steps, across the warmup and a milestone with the clip active, give
  parameters within 1e-6; the LR schedules and the EMA ramp agree;
* the whole step from the same (jittered) flax variables and batch: loss
  within 1e-5 relative, per-leaf gradients within 1e-4 relative to
  ``jax.grad`` of the same composition, BatchNorm statistics after the step
  within 1e-5 (flax moves the running variance toward the biased batch
  variance);
* a batch with a NaN pixel changes nothing in either package but the step
  count: parameters, optimizer state (its update count included) and
  BatchNorm statistics stay.

Gradient parity and optimizer parity are tested apart: the first Adam step
moves a parameter by about lr times the sign of its gradient, so a
gradient of 1e-12 whose sign differs between the packages would move it by
2 lr."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import configs, jitter, tiny_4c_overrides  # noqa: E402

SIZE = 64
SHIFT = 8          # image1 is image0 shifted by this many pixels
LOSS_TOL = 1e-6
OPT_TOL = 1e-6
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5


def _pair_batch(size=SIZE, shift=SHIFT, seed=0, holes=False, masked=False):
    """A textured image0 and image1 = image0 shifted by ``shift`` pixels,
    with constant depth and the camera translation that maps one onto the
    other (focal 100, depth 1), as numpy arrays.  ``holes`` adds depth noise
    and zero-depth holes in both images; ``masked`` adds padding masks and
    per-image scales."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size + shift, 0:size + shift].astype(np.float32)
    f = rng.uniform(0.1, 0.35, (3, 2))
    base = np.stack([0.5 + 0.5 * np.sin(f[c, 0] * yy + f[c, 1] * xx + c)
                     for c in range(3)], -1).astype(np.float32)
    K = np.array([[[100.0, 0, size / 2], [0, 100.0, size / 2], [0, 0, 1]]],
                 np.float32)
    T01 = np.eye(4, dtype=np.float32)[None].copy()
    T01[0, :2, 3] = -shift / 100.0
    batch = {
        "image0": base[None, :size, :size].copy(),
        "image1": base[None, shift:size + shift, shift:size + shift].copy(),
        "depth0": np.ones((1, size, size), np.float32),
        "depth1": np.ones((1, size, size), np.float32),
        "K0": K, "K1": K.copy(), "T_0to1": T01,
        "T_1to0": np.linalg.inv(T01[0])[None].astype(np.float32)}
    if holes:
        for d in ("depth0", "depth1"):
            batch[d] = (1.0 + 0.3 * rng.random((1, size, size))).astype(
                np.float32)
        batch["depth1"][:, 12:28, 20:40] = 0.0
        batch["depth0"][:, 40:44, :] = 0.0
    if masked:
        for i in (0, 1):
            m = np.ones((1, size, size), bool)
            m[:, :, size - 16:] = False
            batch[f"mask{i}"] = m
            batch[f"scale{i}"] = np.array([[1.25, 1.5]], np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --------------------------------------------------------------------------
# supervision
# --------------------------------------------------------------------------

SPV_CASES = {"plain": {}, "holes": {"holes": True},
             "masked_scaled_holes": {"holes": True, "masked": True}}


@pytest.mark.parametrize("case", list(SPV_CASES))
def test_warp_kpts_matches_jax(case):
    from casmtr_tpu.ops.geometry import warp_kpts as jax_warp
    from casmtr_tpu_torch.ops.geometry import warp_kpts
    b = _pair_batch(**SPV_CASES[case])
    rng = np.random.default_rng(1)
    kpts = (rng.random((1, 200, 2)) * (SIZE - 1)).astype(np.float32)
    kpts[0, :10] = np.round(kpts[0, :10])
    args = [kpts] + [b[k] for k in ("depth0", "depth1", "T_0to1", "K0", "K1")]
    want_valid, want_w = jax_warp(*(jnp.asarray(a) for a in args))
    got_valid, got_w = warp_kpts(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0,
                               atol=1e-4)
    if case != "plain":  # both outcomes occur
        assert 0 < int(got_valid.sum()) < kpts.shape[1]


@pytest.mark.parametrize("case", list(SPV_CASES))
def test_compute_supervision_matches_jax(case):
    from casmtr_tpu.train import supervision as jspv
    from casmtr_tpu_torch.train import supervision as tspv
    jcfg, tcfg = configs(tiny_4c_overrides(train_size=SIZE))
    b = _pair_batch(**SPV_CASES[case])
    want = jspv.compute_supervision(_jnp(b), jcfg.loftr)
    got = tspv.compute_supervision(_torch(b), tcfg.loftr)
    assert set(got) == set(want)
    for key in ("conf_matrix_gt_8c", "gt_idx_4c", "gt_mask_4c"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("spv_w_pt0_i", "spv_pt1_i"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    assert got["gt_mask_4c"].sum() > 0
    assert got["conf_matrix_gt_8c"].sum() > 0


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_cfgs(**kw):
    jcfg, tcfg = configs(tiny_4c_overrides(train_size=SIZE))
    return (dataclasses.replace(jcfg.loftr.loss, **kw),
            dataclasses.replace(tcfg.loftr.loss, **kw))


def _loss_pair(jax_fn, torch_fn, diff, fixed):
    """Value and gradient w.r.t. ``diff`` of both losses."""
    jv, jg = jax.value_and_grad(
        lambda x: jax_fn(x, *(jnp.asarray(f) for f in fixed)))(
            jnp.asarray(diff))
    x = torch.from_numpy(diff).requires_grad_(True)
    tv = torch_fn(x, *(torch.from_numpy(f) for f in fixed))
    tv.backward()
    value = float(tv.detach())
    np.testing.assert_allclose(value, float(jv), rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=LOSS_TOL)
    return value


def _softmax(x, axis):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


COARSE_CASES = [("cross_entropy", False, False), ("cross_entropy", False, True),
                ("focal", False, False), ("focal", True, False),
                ("focal", False, True)]


@pytest.mark.parametrize("ctype,sparse,weighted", COARSE_CASES,
                         ids=[f"{c}-{'sparse' if s else 'dense'}-"
                              f"{'weighted' if w else 'plain'}"
                              for c, s, w in COARSE_CASES])
def test_coarse_loss_matches_jax(ctype, sparse, weighted):
    from casmtr_tpu.train.loss import coarse_loss as jax_loss
    from casmtr_tpu_torch.train.loss import coarse_loss
    rng = np.random.default_rng(2)
    conf = _softmax(rng.standard_normal((2, 12, 10)) * 3, 2)
    conf[0, 0, 0] = 1.0                        # hits the clip
    gt = np.zeros_like(conf)
    rows = rng.choice(12, 7, replace=False)
    gt[0, rows, rng.integers(0, 10, 7)] = 1.0
    gt[1, 3, 4] = 1.0
    fixed = [gt]
    if weighted:
        fixed.append((rng.random(conf.shape) > 0.3).astype(np.float32))
    jcfg, tcfg = _loss_cfgs(coarse_type=ctype)
    value = _loss_pair(
        lambda c, g, *w: jax_loss(c, g, jcfg, sparse, *w),
        lambda c, g, *w: coarse_loss(c, g, tcfg, sparse, *w), conf, fixed)
    assert value > 0


@pytest.mark.parametrize("ctype", ["binary_cross_entropy", "cross_entropy",
                                   "focal"])
def test_cascade_loss_matches_jax(ctype):
    from casmtr_tpu.train.loss import cascade_loss as jax_loss
    from casmtr_tpu_torch.train.loss import cascade_loss
    rng = np.random.default_rng(3)
    M, Kw = 8, 9
    conf = _softmax(rng.standard_normal((M, Kw)) * 2, 1)
    gt = np.zeros((M, Kw), bool)
    gt[np.arange(M), rng.integers(0, Kw, M)] = True
    valid = np.array([1, 1, 1, 0, 1, 0, 1, 1], bool)
    jcfg, tcfg = _loss_cfgs(cascade_type=ctype)
    value = _loss_pair(lambda c, g, v: jax_loss(c, g, v, jcfg),
                       lambda c, g, v: cascade_loss(c, g, v, tcfg),
                       conf, [gt, valid])
    assert value > 0


FINE_CASES = [("l2", True), ("l2_with_std", True), ("l2_with_std", False)]


@pytest.mark.parametrize("ftype,any_valid", FINE_CASES,
                         ids=[f"{t}-{'rows' if v else 'no_valid_row'}"
                              for t, v in FINE_CASES])
def test_fine_loss_matches_jax(ftype, any_valid):
    from casmtr_tpu.train.loss import fine_loss as jax_loss
    from casmtr_tpu_torch.train.loss import fine_loss
    rng = np.random.default_rng(4)
    M = 10
    expec = rng.standard_normal((M, 3)).astype(np.float32) * 0.3
    expec[:, 2] = rng.uniform(0.05, 1.0, M)
    gt = (rng.standard_normal((M, 2)) * 0.6).astype(np.float32)
    gt[1] = [np.inf, 0.0]                      # no depth: drops out
    gt[2] = [np.nan, np.nan]
    gt[3] = [1.5, 0.0]                         # beyond fine_correct_thr
    valid = np.ones(M, bool) if any_valid else np.zeros(M, bool)
    valid[-2:] = False
    jcfg, tcfg = _loss_cfgs(fine_type=ftype)
    value = _loss_pair(lambda e, g, v: jax_loss(e, g, v, jcfg),
                       lambda e, g, v: fine_loss(e, g, v, tcfg),
                       expec, [gt, valid])
    assert (value > 0) == any_valid


# --------------------------------------------------------------------------
# optimizer and schedules
# --------------------------------------------------------------------------

def _trainer_cfgs(**kw):
    ov = tiny_4c_overrides(train_size=SIZE)
    ov["trainer"] = kw
    jcfg, tcfg = configs(ov)
    return jcfg.trainer, tcfg.trainer


SCHEDULES = {
    "multistep": dict(scheduler="MultiStepLR", warmup_step=6,
                      warmup_ratio=0.1, mslr_milestones=[1, 3, 5],
                      mslr_gamma=0.5),
    "multistep_no_warmup": dict(scheduler="MultiStepLR", warmup_step=0,
                                mslr_milestones=[2, 4], mslr_gamma=0.3),
    "cosine": dict(scheduler="CosineAnnealing", warmup_step=4,
                   warmup_ratio=0.2, cosa_tmax=5, min_lr=1e-5),
    "exponential": dict(scheduler="ExponentialLR", warmup_step=3,
                        elr_gamma=0.9),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedules_match_jax(name):
    from casmtr_tpu.train import optim as jopt
    from casmtr_tpu_torch.train import optim as topt
    jt, tt = _trainer_cfgs(warmup_step_stages=5, warmup_ratio_stages=0.2,
                           **SCHEDULES[name])
    base, spe, restore = 2e-3, 3, 7
    js = jopt.build_lr_schedule(jt, base, spe)
    ts = topt.build_lr_schedule(tt, base, spe)
    jst = jopt.stage_warmup_schedule(js, jt, base, restore, spe)
    tst = topt.stage_warmup_schedule(ts, tt, base, restore, spe)
    # the JAX schedules compute in float32
    tol = dict(rtol=1e-6, atol=1e-6 * base)
    for step in range(30):
        np.testing.assert_allclose(ts(step), float(js(step)), **tol,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tst(step), float(jst(step)), **tol,
                                   err_msg=f"staged step {step}")


def test_scaling_and_ema_match_jax():
    from casmtr_tpu.train import optim as jopt
    from casmtr_tpu_torch.train import optim as topt
    jt, tt = _trainer_cfgs(ema_warmup=20, steps_range=[5, 100])
    for bs, src in ((8, None), (128, "megadepth"), (16, "ScanNet")):
        assert topt.scaled_lr(tt, bs, src) == pytest.approx(
            jopt.scaled_lr(jt, bs, src))
        assert topt.scaled_warmup_step(tt, bs, src) == \
            jopt.scaled_warmup_step(jt, bs, src)
    for step in (0, 5, 9, 25, 40):
        assert topt.ema_beta_at(step, tt) == pytest.approx(
            float(jopt.ema_beta_at(step, jt)), rel=1e-6)
    rng = np.random.default_rng(5)
    e, p = (rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2))
    want = jopt.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 0.7)
    got = {"w": torch.from_numpy(e.copy())}
    topt.ema_update(got, {"w": torch.from_numpy(p)}, 0.7)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=0, atol=1e-6)


def test_optimizer_matches_optax_on_the_same_gradients():
    """6 updates from the same gradients: the warmup ends after step 3 and
    the milestone (epoch 2 of 2 steps) lands at step 4; gradient norms
    alternate above and below the clip of 0.5.  Every group is used: the
    ViT one (lr x vit_lr_scale), 'main', 'new' (the stage warmup from
    step 2) and 'frozen' (no update, left out of the clip's norm)."""
    from casmtr_tpu.train import optim as jopt
    from casmtr_tpu_torch.train import optim as topt
    jt, tt = _trainer_cfgs(warmup_step=3, warmup_ratio=0.1,
                           mslr_milestones=[2], mslr_gamma=0.5,
                           gradient_clipping=0.5, vit_lr_scale=0.5,
                           adamw_decay=0.01, warmup_step_stages=3,
                           warmup_ratio_stages=0.2)
    rng = np.random.default_rng(6)
    paths = {"backbone.vit_block_0.kernel": (3, 4),
             "loftr_coarse_8c.kernel": (4, 4),
             "head.kernel": (4, 2), "head.bias": (2,),
             "frozen_head.kernel": (2, 3)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in paths.items()}

    def tree(flat):
        out = {}
        for n, v in flat.items():
            *mods, leaf = n.split(".")
            node = out
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = jnp.asarray(v)
        return out

    def flat(tree_):
        return {".".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree_)[0]}

    base_lr, spe, restore = 1e-2, 2, 2
    jp = tree(params)
    tx = jopt.build_optimizer(
        jt, base_lr, spe, new_param_labels=jopt.new_stage_labels(jp),
        restore_step=restore, frozen_label_fn=lambda path: any(
            getattr(k, "key", k) == "frozen_head" for k in path))
    js = tx.init(jp)
    ttx = topt.build_optimizer(
        tt, base_lr, spe, new_param_labels=topt.new_stage_labels(params),
        restore_step=restore,
        frozen_label_fn=lambda name: name.startswith("frozen_head"))
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    ts = ttx.init(tp)
    assert ts.labels == {"backbone.vit_block_0.kernel": "vit",
                         "loftr_coarse_8c.kernel": "main",
                         "head.kernel": "new", "head.bias": "new",
                         "frozen_head.kernel": "frozen"}
    for step, scale in enumerate((2.0, 0.05, 3.0, 0.1, 1.5, 0.02)):
        grads = {n: (scale * rng.standard_normal(v.shape)).astype(np.float32)
                 for n, v in params.items()}
        upd, js = tx.update(tree(grads), js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        ttx.update(tp, {n: torch.from_numpy(g) for n, g in grads.items()},
                   ts)
        want = flat(jp)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), want[n], rtol=0,
                                       atol=OPT_TOL,
                                       err_msg=f"{n} after step {step}")
    assert ts.count == ts.schedule_count == 6
    np.testing.assert_array_equal(tp["frozen_head.kernel"].numpy(),
                                  params["frozen_head.kernel"])


# --------------------------------------------------------------------------
# the whole step
# --------------------------------------------------------------------------

def _step_overrides():
    """The tiny 4c configuration; the 1/4 double check is off so that the
    random-weight model keeps enough 1/4 matches for the cascade and fine
    losses to carry gradients (the double check is the eval tail that
    test_torch_slice.py covers)."""
    ov = tiny_4c_overrides(train_size=SIZE)
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    return ov


@pytest.fixture(scope="module")
def step_run():
    """One step of each package from the same jittered flax variables and
    batch, then one step each on a batch with a NaN pixel.  The flax side is
    jitted once; its variable tree comes from ``jax.eval_shape`` and the
    values from the port's seeded initialization, jittered."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu.train import supervision as jspv
    from casmtr_tpu.train.loss import casmtr_loss as jax_loss
    from casmtr_tpu.train.optim import build_optimizer as jax_build
    from casmtr_tpu.train.train_step import TrainState as JaxState
    from casmtr_tpu.train.train_step import make_train_step as jax_step
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    from casmtr_tpu_torch.weights import (init_random_, jax_variables,
                                          load_jax_variables)
    jcfg, tcfg = configs(_step_overrides())
    batch = _pair_batch()
    nan_batch = {k: v.copy() for k, v in batch.items()}
    nan_batch["image0"][0, 5, 7, 1] = np.nan

    jm = JaxCasMTR(jcfg.loftr)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            _jnp(batch), train=False))
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  dict(shapes))
    model = build_model(tcfg.loftr)
    # seed 1: the random model's 1/4 matches include some close enough to
    # their ground truth for the fine loss to count them
    init_random_(model, torch.Generator().manual_seed(1))
    variables = jitter(jax_variables(model.state_dict(), like), seed=1)
    load_jax_variables(model, variables)

    # JAX: the package's step, and jax.grad of the same composition
    tx = jax_build(jcfg.trainer, 1e-3, 100)
    step_fn = jax_step(jm, jcfg, tx)

    def grads_fn(params, bs, b):
        gt = jspv.compute_supervision(b, jcfg.loftr)
        b = dict(b, gt_idx_4c=gt["gt_idx_4c"], gt_mask_4c=gt["gt_mask_4c"])

        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": bs}, b,
                              train=True, mutable=["batch_stats"])
            eg = jspv.fine_expec_gt(gt, out.cascades["4c"].matches, b,
                                    jcfg.loftr)
            return jax_loss(out, gt, eg, jcfg.loftr)[0]

        return jax.grad(loss_fn)(params)

    both = jax.jit(lambda s, b: (step_fn(s, b),
                                 grads_fn(s.params, s.batch_stats, b)))
    p0 = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state0 = JaxState(jnp.zeros((), jnp.int32), p0,
                      jax.tree_util.tree_map(jnp.asarray,
                                             variables["batch_stats"]),
                      tx.init(p0))
    (jstate1, jscalars), jgrads = both(state0, _jnp(batch))
    (jstate_nan, jscalars_nan), _ = both(jstate1, _jnp(nan_batch))

    # the port
    state, ttx = init_train_state(model, tcfg, 100, 1e-3, device="cpu")
    step = make_train_step(model, tcfg, ttx, device="cpu")
    state, tscalars = step(state, batch)
    tgrads = jax_variables(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()}, {"params": like["params"]})
    tstats = jax_variables(model.state_dict(),
                           {"batch_stats": like["batch_stats"]})
    before = {"params": {n: p.detach().clone()
                         for n, p in model.named_parameters()},
              "buffers": {n: b.clone() for n, b in model.named_buffers()},
              "mu": {n: t.clone() for n, t in state.opt_state.mu.items()},
              "nu": {n: t.clone() for n, t in state.opt_state.nu.items()},
              "counts": (state.opt_state.count,
                         state.opt_state.schedule_count)}
    state, tscalars_nan = step(state, nan_batch)
    return dict(jstate0=state0, jstate1=jstate1, jscalars=jscalars,
                jgrads=jgrads, jstate_nan=jstate_nan,
                jscalars_nan=jscalars_nan, tscalars=tscalars,
                tgrads=tgrads["params"], tstats=tstats["batch_stats"],
                before=before, tstate=state, model=model,
                tscalars_nan=tscalars_nan)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js)
    for k in ("loss", "loss_8c", "loss_4c", "loss_f", "grad_norm"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                   rtol=STEP_LOSS_RTOL, err_msg=k)
    assert int(ts["valid_n_4c"]) == int(js["valid_n_4c"]) > 0
    assert float(ts["loss_4c"]) > 0 and float(ts["loss_f"]) > 0


def test_train_step_gradients_match_jax(step_run):
    """Per leaf, ||g_port - g_jax|| <= 1e-4 ||g_jax||.  A leaf whose gradient
    vanishes analytically (a LayerNorm bias in front of a training-mode
    BatchNorm, which removes any per-channel shift) holds only summation
    noise, so the leaf norm is floored at 1e-3 of the whole gradient's."""
    want = _leaves(step_run["jgrads"])
    got = _leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * scale, f"{k}: relative error {err / scale}"
    nonzero = sum(float(np.abs(w).sum()) > 0 for w in want.values())
    assert nonzero > 0.9 * len(want)


def test_train_step_batch_stats_match_jax(step_run):
    want = _leaves(step_run["jstate1"].batch_stats)
    got = _leaves(step_run["tstats"])
    start = _leaves(step_run["jstate0"].batch_stats)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"


def test_nan_batch_skips_the_update_in_jax(step_run):
    s1, sn = step_run["jstate1"], step_run["jstate_nan"]
    assert not np.isfinite(float(step_run["jscalars_nan"]["loss"]))
    assert int(sn.step) == int(s1.step) + 1
    for name in ("params", "batch_stats", "opt_state"):
        a, b = _leaves(getattr(s1, name)), _leaves(getattr(sn, name))
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name} {k}")


def test_nan_batch_skips_the_update_in_the_port(step_run):
    before, state = step_run["before"], step_run["tstate"]
    model = step_run["model"]
    assert not np.isfinite(float(step_run["tscalars_nan"]["loss"]))
    assert state.step == 2
    assert (state.opt_state.count, state.opt_state.schedule_count) == \
        before["counts"] == (1, 1)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before["params"][n]), n
    for n, b in model.named_buffers():
        assert torch.equal(b, before["buffers"][n]), n
    for n in before["mu"]:
        assert torch.equal(state.opt_state.mu[n], before["mu"][n]), n
        assert torch.equal(state.opt_state.nu[n], before["nu"][n]), n


def test_train_step_runs_on_the_card_by_default():
    """Without a device the step goes to CUDA, and raises where there is
    none."""
    from casmtr_tpu_torch.models import build_model
    from casmtr_tpu_torch.train.train_step import (init_train_state,
                                                   make_train_step)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    _, tcfg = configs(_step_overrides())
    model = build_model(tcfg.loftr)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(model, tcfg, 100, 1e-3)
    _, ttx = init_train_state(model, tcfg, 100, 1e-3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, tcfg, ttx)
