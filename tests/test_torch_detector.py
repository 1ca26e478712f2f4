"""The cascade keypoint-detector branch in the port against the JAX package,
on the CPU at tiny sizes:

* the learnable head (3x3 conv, BatchNorm, SiLU, 1x1 conv) of the tiny 4c
  cascade stack in train mode: heatmap within 1e-5, its BatchNorm
  statistics within 1e-5;
* ``detect_keypoints`` in the ST and gumbel modes, the gumbel mode on the
  JAX package's own uniform draw: the same picks, outputs within 1e-6, and
  the straight-through gradients of the heatmap and the confidences within
  1e-5;
* ``select_detector_labels``: the same labels, selected rows and valid
  slots;
* the detector term of ``casmtr_loss`` (``loss_4c_det``) within 1e-6;
* ``train_step.detector_uniforms``: the gumbel draw's shape and range, the
  same draw for the same (seed, step) and another for the next step.

One training step with the detector (the learnable head and the ST
detector on the 1/4 level of a 4c model) is tests/test_torch_refine.py's
refine step, at test_torch_train.py's tolerances: one compiled JAX step
holds both there.

The tolerances were fixed before the first run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_train import _leaves as leaves  # noqa: E402
from tests.test_torch_train import _step_overrides  # noqa: E402
from tests.torch_parity import configs, port_variables  # noqa: E402

HEAT_ATOL = 1e-5
BN_ATOL = 1e-5
DET_ATOL = 1e-6
DET_GRAD_ATOL = 1e-5
LOSS_ATOL = 1e-6


def _detector_overrides(**loftr):
    """The tiny 4c configuration of test_torch_train.py's step with the
    learnable head and the ST detector on its 1/4 level."""
    ov = _step_overrides()
    ov["loftr"]["coarse2"].update(detector="learnable", detector_mode="ST",
                                  grid_size=4)
    ov["loftr"].update(loftr)
    return ov


def test_detector_head_matches_flax():
    from casmtr_tpu.models.cascade_transformer import \
        CascadeFeatureTransformer as JaxCFT
    from casmtr_tpu_torch.models.cascade_transformer import \
        CascadeFeatureTransformer
    from casmtr_tpu_torch.weights import jax_variables, load_jax_variables
    jcfg, tcfg = configs(_detector_overrides())
    rng = np.random.default_rng(3)
    hw = (16, 20)
    f0, f1 = (rng.standard_normal((2, 320, 12)).astype(np.float32)
              for _ in range(2))
    idx01, idx10 = (rng.integers(0, 80, (2, 80)).astype(np.int32)
                    for _ in range(2))
    jm = JaxCFT(jcfg.loftr.coarse2, 32, remat=False, train_mode=True)
    jargs = [jnp.asarray(a) for a in (f0, f1, idx01, idx10)]
    tm = CascadeFeatureTransformer(tcfg.loftr.coarse2)
    variables = port_variables(tm, lambda: jm.init(
        jax.random.PRNGKey(0), *jargs, hw, hw, train=True))
    load_jax_variables(tm, variables)
    assert any("detector_1" in k for k in leaves(variables["batch_stats"]))
    want, mutated = jax.jit(lambda v, *a: jm.apply(
        v, *a, hw, hw, train=True, mutable=["batch_stats"]))(variables,
                                                              *jargs)
    tm.train()
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (f0, f1)),
                 *(torch.from_numpy(a).long() for a in (idx01, idx10)),
                 hw, hw)
    assert got[6].shape == (2, *hw) and got[6].dtype == torch.float32
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[4]), rtol=0,
                               atol=HEAT_ATOL)
    stats = leaves(jax_variables(tm.state_dict(), {
        "batch_stats": variables["batch_stats"]})["batch_stats"])
    for k, w in leaves(mutated["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
    tm.eval()
    with torch.no_grad():
        assert tm(*(torch.from_numpy(a) for a in (f0, f1)),
                  *(torch.from_numpy(a).long() for a in (idx01, idx10)),
                  hw, hw)[6] is None


@pytest.mark.parametrize("mode", ["ST", "gumbel"])
def test_detect_keypoints_matches_jax(mode):
    from casmtr_tpu.ops.cascade_matching import detect_keypoints as jax_det
    from casmtr_tpu_torch.ops.cascade_matching import detect_keypoints
    rng = np.random.default_rng(5)
    B, H, W, K, g = 2, 8, 12, 9, 4
    heat = rng.standard_normal((B, H, W)).astype(np.float32)
    conf = rng.random((B, H * W, K)).astype(np.float32)
    cot = rng.standard_normal((B, H * W, K)).astype(np.float32)
    key = jax.random.PRNGKey(7) if mode == "gumbel" else None
    # the JAX function's own draw, for the port
    uniform = (np.asarray(jax.random.uniform(
        key, (B, (H // g) * (W // g), g * g), minval=1e-9, maxval=1.0))
        if mode == "gumbel" else None)
    want, vjp = jax.vjp(lambda h, c: jax_det(h, c, mode, g, rng_key=key),
                        jnp.asarray(heat), jnp.asarray(conf))
    want_gh, want_gc = vjp(jnp.asarray(cot))
    th = torch.from_numpy(heat).requires_grad_()
    tc = torch.from_numpy(conf).requires_grad_()
    got = detect_keypoints(th, tc, mode, g, None if uniform is None
                           else torch.from_numpy(uniform.copy()))
    got.backward(torch.from_numpy(cot))
    picks = got.detach().abs().sum(-1).numpy() > 0
    np.testing.assert_array_equal(picks, np.abs(np.asarray(want)).sum(-1) > 0)
    assert picks.sum() == B * (H // g) * (W // g)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=DET_ATOL)
    for t, w in ((th, want_gh), (tc, want_gc)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=DET_GRAD_ATOL)


def test_select_detector_labels_matches_jax():
    from casmtr_tpu.ops.cascade_matching import \
        select_detector_labels as jax_sel
    from casmtr_tpu_torch.ops.cascade_matching import select_detector_labels
    rng = np.random.default_rng(6)
    B, L0, Kw, L1, m_cap = 2, 48, 9, 60, 24
    det = rng.random((B, L0, Kw)).astype(np.float32) / 4
    det[rng.random((B, L0)) < 0.5] = 0.0                  # unpicked rows
    base = rng.random((B, L0)) < 0.8
    idx = rng.integers(0, L1, (B, L0, Kw)).astype(np.int32)
    gt_idx = np.where(rng.random((B, L0)) < 0.7,
                      idx[:, :, 4], rng.integers(0, L1, (B, L0))
                      ).astype(np.int32)
    gt_mask = rng.random((B, L0)) < 0.9
    want = jax_sel(jnp.asarray(det), jnp.asarray(base), jnp.asarray(idx),
                   jnp.asarray(gt_idx), jnp.asarray(gt_mask), m_cap)
    got = select_detector_labels(
        torch.from_numpy(det), torch.from_numpy(base),
        torch.from_numpy(idx).long(), torch.from_numpy(gt_idx).long(),
        torch.from_numpy(gt_mask), m_cap)
    valid = np.asarray(want[2])
    assert 0 < valid.sum() < m_cap
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy()[valid],
                                  np.asarray(want[0])[valid])
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(want[1])[valid])


def test_detector_loss_term_matches_jax():
    from casmtr_tpu import structs as js
    from casmtr_tpu.train.loss import casmtr_loss as jax_loss
    from casmtr_tpu_torch import structs as ts
    from casmtr_tpu_torch.train.loss import casmtr_loss
    jcfg, tcfg = configs(_detector_overrides())
    rng = np.random.default_rng(8)
    M, Kw = 16, 9
    labels = np.eye(Kw, dtype=bool)[rng.integers(0, Kw, (2, M))]
    conf = rng.random((2, M, Kw)).astype(np.float32)
    valid = rng.random((2, M)) < 0.7
    arrays = dict(window_gt_label=labels[0], window_conf=conf[0],
                  detector_gt_label=labels[1], detector_conf=conf[1])
    matches = dict(b_ids=np.zeros(M, np.int32), i_ids=np.zeros(M, np.int32),
                   j_ids=np.zeros(M, np.int32), mconf=conf[0, :, 0],
                   mkpts0=conf[0, :, :2], mkpts1=conf[0, :, :2])
    outs = []
    for mod, conv in ((js, jnp.asarray), (ts, torch.from_numpy)):
        m = mod.Matches(valid=conv(valid[0]),
                        **{k: conv(v) for k, v in matches.items()})
        st = mod.CascadeStage(
            conf_matrix=None, idx_c01=None, idx_c10=None, next_idx_c01=None,
            next_idx_c10=None, next_conf_c01=None, next_conf_c10=None,
            matches=m, hw0=(4, 4), hw1=(4, 4), detector_valid=conv(valid[1]),
            **{k: conv(v) for k, v in arrays.items()})
        outs.append(mod.MatchOutput(
            coarse=None, cascades={"4c": st}, fine=None, final_matches=m,
            hw0_i=(16, 16), hw1_i=(16, 16)))
    _, want = jax_loss(outs[0], {}, None, jcfg.loftr, opt_coarse=False)
    _, got = casmtr_loss(outs[1], {}, None, tcfg.loftr, opt_coarse=False)
    assert set(got) == set(want) == {"loss", "loss_4c", "loss_4c_det"}
    assert float(want["loss_4c_det"]) > 0
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)


def test_detector_uniforms_are_seeded_per_step():
    from casmtr_tpu_torch.train.train_step import detector_uniforms
    _, tcfg = configs(_detector_overrides())
    batch = {"image0": torch.zeros(2, 64, 96, 3)}
    assert detector_uniforms(tcfg.loftr, batch, 66, 0) == {}
    _, gcfg = configs(_detector_overrides(
        coarse2={"detector_mode": "gumbel", "grid_size": 4}))
    a = detector_uniforms(gcfg.loftr, batch, 66, 3)
    assert set(a) == {"sample_uniform_4c"}
    u = a["sample_uniform_4c"]
    assert u.shape == (2, (16 // 4) * (24 // 4), 16)
    assert float(u.min()) >= 1e-9 and float(u.max()) < 1.0
    assert torch.equal(u, detector_uniforms(gcfg.loftr, batch, 66, 3)[
        "sample_uniform_4c"])
    assert not torch.equal(u, detector_uniforms(gcfg.loftr, batch, 66, 4)[
        "sample_uniform_4c"])
