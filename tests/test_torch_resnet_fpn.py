"""The ResNet-FPN backbones of the PyTorch port against the JAX package's, on
the CPU, with the flax variables carried across by ``load_jax_variables``:

* ``ResNetFPN_8_4_2`` and ``ResNetFPN_8_2`` at tiny widths, RGB and gray,
  on an odd 70x90 input (no stride divides it: the explicit stem padding 3
  and conv3x3 padding 1 against flax's SAME-sized 1x1 strided shortcut), in
  eval mode and in train mode (batch statistics; the running statistics
  after the forward within 1e-5); maps within 1e-4;
* the flagship's ResNetFPN variant of CasMTR-4c (``outdoor_casmtr_4c`` with
  ``__graft_entry__._flagship_cfg(backbone="resnet")``'s backbone, here at
  the tiny widths of tests/torch_parity.py): the eval forward with every
  threshold at 0, the same valid (b, i, j) sets at the 1/8 and 1/4 stages
  and at the end (keypoints within 1e-3 px, confidences within 1e-4), and
  its ``Matcher`` against the JAX ``Matcher``;
* one training step of the variant against the JAX package's step and
  ``jax.grad`` of the same composition, within the tolerances of
  test_torch_train.py: loss terms 1e-5 relative, per-leaf gradients 1e-4
  relative (leaf norms floored at 1e-3 of the whole gradient's), BatchNorm
  statistics 1e-5; but the fine loss and the gradient norm within 1e-4,
  the gradients' tolerance.  The tiny random variant supervises two fine
  rows (valid_n_4c = 2, against 16 in test_torch_train.py), so its fine
  loss is the mean of two squared offsets, whose relative error is twice
  the offsets' float32 error over their size, and the gradient norm
  follows it."""

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
from tests.torch_parity import (configs, jitter, port_variables,  # noqa
                                tiny_4c_overrides)

MAP_ATOL = 1e-4
BN_ATOL = 1e-5
PX_ATOL = 1e-3
CONF_ATOL = 1e-4
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the terms held at GRAD_RTOL: the mean over two fine rows, and the norm
STEP_RTOL = {"loss": STEP_LOSS_RTOL, "loss_8c": STEP_LOSS_RTOL,
             "loss_4c": STEP_LOSS_RTOL, "loss_f": GRAD_RTOL,
             "grad_norm": GRAD_RTOL}
TRAIN_SIZE = 64
INITIAL_DIM, BLOCK_DIMS = 8, (8, 12, 16)


def resnet_overrides(**kw):
    """The tiny 4c configuration with the flagship variant's backbone type
    (ResNetFPN, initial_dim equal to block_dims[0], RGB as the recipe)."""
    ov = tiny_4c_overrides(**kw)
    ov["loftr"]["backbone"] = {"backbone_type": "ResNetFPN",
                               "initial_dim": INITIAL_DIM,
                               "block_dims": list(BLOCK_DIMS)}
    return ov


# --------------------------------------------------------------------------
# the backbones
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_runs():
    """{(name, is_rgb): (input, variables, eval maps, (train maps, batch
    statistics after the forward))}: each module's jittered variables from
    the port's seeded weights on the flax init's tree (traced, not
    compiled), applied in both modes by one jitted call."""
    from casmtr_tpu.models.backbone import resnet_fpn as jrf
    from casmtr_tpu_torch.models.backbone import resnet_fpn as trf
    image = np.random.default_rng(0).random((2, 70, 90, 3)).astype(
        np.float32)
    x = jnp.asarray(image)
    runs = {}

    def get(name, is_rgb):
        if (name, is_rgb) not in runs:
            jm = getattr(jrf, name)(initial_dim=INITIAL_DIM,
                                    block_dims=BLOCK_DIMS, is_rgb=is_rgb)
            variables = port_variables(
                getattr(trf, name)(INITIAL_DIM, BLOCK_DIMS, is_rgb),
                lambda: jm.init(jax.random.PRNGKey(0), x))
            both = jax.jit(lambda v, x: (jm.apply(v, x), jm.apply(
                v, x, train=True, mutable=["batch_stats"])))
            runs[name, is_rgb] = (image, variables, *both(variables, x))
        return runs[name, is_rgb]

    return get


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("is_rgb", [True, False], ids=["rgb", "gray"])
@pytest.mark.parametrize("name", ["ResNetFPN_8_4_2", "ResNetFPN_8_2"])
def test_resnet_fpn_matches_flax(flax_runs, name, is_rgb, train):
    from casmtr_tpu_torch.models.backbone import resnet_fpn as trf
    from casmtr_tpu_torch.weights import jax_variables, load_jax_variables
    image, variables, want, (want_train, new) = flax_runs(name, is_rgb)
    if train:
        want = want_train
    tm = getattr(trf, name)(INITIAL_DIM, BLOCK_DIMS, is_rgb)
    load_jax_variables(tm, variables)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(image).permute(0, 3, 1, 2))
    assert len(got) == len(want) == (3 if name.endswith("4_2") else 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=0, atol=MAP_ATOL)
    stats = jax_variables(tm.state_dict(),
                          {"batch_stats": new["batch_stats"]})
    got_s = leaves(stats["batch_stats"])
    want_s = leaves((new if train else variables)["batch_stats"])
    start = leaves(variables["batch_stats"])
    assert got_s.keys() == want_s.keys()
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert train != np.array_equal(w, start[k]), k


def test_build_backbone_dispatches_like_the_jax_registry():
    from dataclasses import replace

    from casmtr_tpu_torch.models.backbone import build_backbone
    from casmtr_tpu_torch.models.backbone.resnet_fpn import (ResNetFPN_8_2,
                                                             ResNetFPN_8_4_2)
    from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_8_4_2
    _, tcfg = configs(resnet_overrides())
    lcfg = tcfg.loftr
    bb = build_backbone(lcfg)
    assert type(bb) is ResNetFPN_8_4_2 and bb.conv1.in_channels == 3
    assert bb.layer1[0].conv1.in_channels == INITIAL_DIM
    bb = build_backbone(replace(lcfg, is_rgb=False, resolution=(8, 2)))
    assert type(bb) is ResNetFPN_8_2 and bb.conv1.in_channels == 1
    _, tcfg = configs(tiny_4c_overrides())
    assert type(build_backbone(tcfg.loftr)) is TwinsFPN_8_4_2
    # every (type, resolution) pair against the JAX registry: the same
    # class, or ValueError in both (ResNetFPN off its three resolutions)
    from casmtr_tpu.models.backbone import build_backbone as jax_build
    jcfg, tcfg = configs(tiny_4c_overrides())
    built = set()
    for kind in ("ResNetFPN", "Twins"):
        for res in ((8, 2), (8, 4, 2), (16, 4), (16, 8, 4, 2), (8, 4)):
            j, t = (replace(c.loftr, resolution=res, backbone=replace(
                c.loftr.backbone, backbone_type=kind, block_dims=(8, 12, 16,
                                                                24)))
                    for c in (jcfg, tcfg))
            try:
                want = type(jax_build(j)).__name__
            except ValueError:
                with pytest.raises(ValueError, match="unsupported resolution"):
                    build_backbone(t)
                continue
            assert type(build_backbone(t)).__name__ == want, (kind, res)
            built.add(want)
    assert built == {"ResNetFPN_8_2", "ResNetFPN_8_4_2", "ResNetFPN_16_4",
                     "TwinsFPN_8_4_2", "TwinsFPN_16_8_4_2"}


# --------------------------------------------------------------------------
# the flagship's ResNetFPN variant: eval forward and Matcher
# --------------------------------------------------------------------------

def test_resnet_variant_eval_forward_matches_jax():
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    jcfg, tcfg = configs(resnet_overrides(zero_thresholds=True))
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
    pairs = [(got.coarse.matches, want.coarse.matches),
             (got.cascades["4c"].matches, want.cascades["4c"].matches)]
    for g, w in pairs:
        _assert_same_matches(_fields(g), _fields(w))
    want_f, got_f = _fields(want.final_matches), _fields(got.final_matches)
    want_f["expec_f"] = np.asarray(want.fine.expec_f)
    got_f["expec_f"] = got.fine.expec_f.numpy()
    _assert_same_matches(got_f, want_f)


def test_resnet_variant_matcher_answers_like_jax_matcher():
    from casmtr_tpu.serving import Matcher as JaxMatcher
    from casmtr_tpu_torch.serving import Matcher
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = resnet_overrides(zero_thresholds=True)
    jmatch = JaxMatcher("outdoor_casmtr_4c", bucket=128, df=32, thr=0.0,
                        overrides=ov)
    jmatch.variables = jitter(jmatch.variables)
    tmatch = Matcher("outdoor_casmtr_4c", bucket=128, df=32, thr=0.0,
                     overrides=ov, device="cpu")
    load_jax_variables(tmatch.model, jmatch.variables)
    img0, img1 = (x[0] for x in _images(np.random.default_rng(1), 1, 128,
                                        128))
    want = jmatch.match(img0, img1)
    got = tmatch.match(img0, img1)
    assert len(want.mconf) > 0 and len(got.mconf) == len(want.mconf)
    og, ow = np.lexsort(got.mkpts0.T), np.lexsort(want.mkpts0.T)
    for name, atol in (("mkpts0", PX_ATOL), ("mkpts1", PX_ATOL),
                       ("mconf", CONF_ATOL)):
        np.testing.assert_allclose(getattr(got, name)[og],
                                   getattr(want, name)[ow], rtol=0,
                                   atol=atol)


# --------------------------------------------------------------------------
# the variant's training step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_run():
    """One step of each package from the same jittered variables and batch
    (the 1/4 double check off, as in test_torch_train.py, so that the
    random model keeps 1/4 matches for the cascade and fine losses)."""
    ov = resnet_overrides(train_size=TRAIN_SIZE)
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    jcfg, tcfg = configs(ov)
    batch = _pair_batch(size=TRAIN_SIZE)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    return dict(zip(("jscalars", "jgrads", "jstats"),
                    jax_step(jm, jcfg, variables, batch)),
                **dict(zip(("tscalars", "tgrads", "tstats"),
                           torch_step(tcfg, variables, like, batch))),
                start=variables["batch_stats"])


def test_resnet_variant_train_step_loss_matches_jax(step_run):
    js, ts = step_run["jscalars"], step_run["tscalars"]
    assert set(ts) == set(js)
    for k, rtol in STEP_RTOL.items():
        print(f"{k}: relative error {abs(float(ts[k]) / float(js[k]) - 1):.2e}"
              f", tolerance {rtol:g}")
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=rtol,
                                   err_msg=k)
    assert int(ts["valid_n_4c"]) == int(js["valid_n_4c"]) == 2
    assert float(ts["loss_4c"]) > 0 and float(ts["loss_f"]) > 0


def test_resnet_variant_train_step_gradients_match_jax(step_run):
    want, got = leaves(step_run["jgrads"]), leaves(step_run["tgrads"])
    assert got.keys() == want.keys()
    assert any("layer3_outconv" in k for k in want)
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(float(np.linalg.norm(w)), 1e-3 * total)
        err = float(np.linalg.norm(got[k] - w))
        assert err <= GRAD_RTOL * scale, f"{k}: relative error {err / scale}"


def test_resnet_variant_train_step_batch_stats_match_jax(step_run):
    want, got = leaves(step_run["jstats"]), leaves(step_run["tstats"])
    start = leaves(step_run["start"])
    assert got.keys() == want.keys()
    assert any("downsample_1" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert not np.array_equal(w, start[k]), f"{k} did not move"
