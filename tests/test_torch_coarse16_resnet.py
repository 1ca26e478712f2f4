"""R16: ``quadtree_baseline`` on ResNetFPN_16_4 (gray, resolution (16, 4),
coarse_level 16) in the port against the JAX package, on the CPU at tiny
widths (``torch_parity.tiny_coarse16_overrides("R16")``):

* ``ResNetFPN_16_4`` alone, RGB and gray, on an odd 70x90 input, in eval
  and in train mode, at test_torch_resnet_fpn.py's tolerances: its [1/16,
  1/4] maps within 1e-4, the running statistics after the forward within
  1e-5;
* the tests shared with the Twins file (tests/torch_coarse16.py): the eval
  forward, the ``Matcher``, one training step, the strict reference-format
  round trip and the refused cascade.

The step keeps every candidate at each quadtree level (topks 4 / 16 on the
8^2 / 4^2 / 2^2 pyramid of its 128^2 pair): with the tiny topks 4 / 4 an
intermediate-level pick of this random gray model sits on a near tie, and
the JAX package's own train-mode confidences move by 3e-3 under a 1e-6
relative nudge of the images, so neither package's float32 rounding
decides it the same way twice.  The eval and Matcher tests keep topks 4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_train import _leaves as leaves  # noqa: E402
from tests.torch_coarse16 import (  # noqa: E402,F401
    BN_ATOL, coarse16_step_run,
    test_coarse16_backbone_under_a_cascade_is_refused,
    test_coarse16_eval_forward_matches_jax,
    test_coarse16_matcher_answers_like_jax_matcher,
    test_coarse16_reference_state_dict_round_trip_is_strict,
    test_coarse16_train_step_batch_stats_match_jax,
    test_coarse16_train_step_gradients_match_jax,
    test_coarse16_train_step_loss_matches_jax)
from tests.torch_parity import port_variables  # noqa: E402

MAP_ATOL = 1e-4
INITIAL_DIM, BLOCK_DIMS = 8, (8, 12, 16, 24)


@pytest.fixture(scope="module")
def kind():
    return "R16"


@pytest.fixture(scope="module")
def step_run():
    return coarse16_step_run("R16", topks=[4, 16, 16])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("is_rgb", [True, False], ids=["rgb", "gray"])
def test_resnet_fpn_16_4_matches_flax(is_rgb, train):
    from casmtr_tpu.models.backbone.resnet_fpn import \
        ResNetFPN_16_4 as JaxResNetFPN_16_4
    from casmtr_tpu_torch.models.backbone.resnet_fpn import ResNetFPN_16_4
    from casmtr_tpu_torch.weights import jax_variables, load_jax_variables
    image = np.random.default_rng(0).random((2, 70, 90, 3)).astype(
        np.float32)
    x = jnp.asarray(image)
    jm = JaxResNetFPN_16_4(initial_dim=INITIAL_DIM, block_dims=BLOCK_DIMS,
                           is_rgb=is_rgb)
    tm = ResNetFPN_16_4(INITIAL_DIM, BLOCK_DIMS, is_rgb)
    variables = port_variables(tm, lambda: jm.init(jax.random.PRNGKey(0), x))
    want, new = jax.jit(lambda v, x: jm.apply(
        v, x, train=train, mutable=["batch_stats"]))(variables, x)
    load_jax_variables(tm, variables)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(image).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(2, 24, 5, 6), (2, 12, 18, 23)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=0, atol=MAP_ATOL)
    stats = jax_variables(tm.state_dict(),
                          {"batch_stats": new["batch_stats"]})
    got_s = leaves(stats["batch_stats"])
    want_s = leaves(new["batch_stats"])
    start = leaves(variables["batch_stats"])
    assert got_s.keys() == want_s.keys()
    assert any(k.startswith("['layer4_1']") for k in want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert train != np.array_equal(w, start[k]), k
