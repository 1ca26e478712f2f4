"""T16: ``quadtree_baseline`` on TwinsFPN_16_8_4_2 (RGB, resolution (16, 8,
4, 2), coarse_level 16) in the port against the JAX package, on the CPU at
tiny widths (``torch_parity.tiny_coarse16_overrides("T16")``):

* ``TwinsFPN_16_8_4_2`` alone (Twins ``small``, 8 / [8, 12, 16, 24]) on an
  odd 70x90 input, in eval and in train mode: its [1/16, 1/8, 1/4, 1/2]
  maps within 1e-4, the running statistics after the forward within 1e-5
  (test_torch_resnet_fpn.py's tolerances);
* the ViT's third stage cut to two blocks whatever the preset's depth (18
  for ``large``, 10 for ``small``), its leaves exactly the JAX module's;
* the tests shared with the ResNetFPN file (tests/torch_coarse16.py): the
  eval forward, the ``Matcher``, one training step (the tiny topks 4 / 4),
  the strict reference-format round trip and the refused cascade."""

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
from tests.torch_parity import flax_like, port_variables  # noqa: E402

MAP_ATOL = 1e-4
INITIAL_DIM, BLOCK_DIMS = 8, (8, 12, 16, 24)


@pytest.fixture(scope="module")
def kind():
    return "T16"


@pytest.fixture(scope="module")
def step_run():
    return coarse16_step_run("T16")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_twins_fpn_16_8_4_2_matches_flax(train):
    from casmtr_tpu.models.backbone.twins import \
        TwinsFPN_16_8_4_2 as JaxTwinsFPN_16_8_4_2
    from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_16_8_4_2
    from casmtr_tpu_torch.weights import jax_variables, load_jax_variables
    image = np.random.default_rng(0).random((2, 70, 90, 3)).astype(
        np.float32)
    x = jnp.asarray(image)
    jm = JaxTwinsFPN_16_8_4_2(initial_dim=INITIAL_DIM, block_dims=BLOCK_DIMS,
                              model_type="small")
    tm = TwinsFPN_16_8_4_2(INITIAL_DIM, BLOCK_DIMS, "small")
    variables = port_variables(tm, lambda: jm.init(jax.random.PRNGKey(0), x))
    want, new = jax.jit(lambda v, x: jm.apply(
        v, x, train=train, mutable=["batch_stats"]))(variables, x)
    load_jax_variables(tm, variables)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(image).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [
        (2, 24, 4, 5), (2, 16, 8, 11), (2, 12, 17, 22), (2, 8, 35, 45)]
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
    assert any(k.startswith("['layer4_outconv_1']") for k in want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
        assert train != np.array_equal(w, start[k]), k


@pytest.mark.parametrize("model_type", ["small", "large"])
def test_twins_third_stage_has_two_blocks(model_type):
    """The port's three-stage Twins ViT against the flax module's variable
    tree (traced, not compiled): stage depths (2, 2, 2) against the
    preset's (2, 2, 10) or (2, 2, 18), and the same leaves, each of the
    same shape, under the reference's names."""
    from casmtr_tpu.models.backbone.twins import \
        TwinsFPN_16_8_4_2 as JaxTwinsFPN_16_8_4_2
    from casmtr_tpu_torch.models.backbone.twins import (TWINS_PRESETS,
                                                        TwinsFPN_16_8_4_2)
    from casmtr_tpu_torch.weights import flax_path_to_torch_key
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jm = JaxTwinsFPN_16_8_4_2(model_type=model_type)
    like = flax_like(lambda: jm.init(jax.random.PRNGKey(0), x))
    tm = TwinsFPN_16_8_4_2(model_type=model_type)
    assert TWINS_PRESETS[model_type]["depths"][2] > 2
    assert [len(stage) for stage in tm.vit.blocks] == [2, 2, 2]
    want = {}
    for col in ("params", "batch_stats"):
        for path, v in jax.tree_util.tree_flatten_with_path(like[col])[0]:
            keys = tuple(p.key for p in path)
            want[flax_path_to_torch_key(keys[:-1], keys[-1])] = v.shape
    got = {k: v.shape for k, v in tm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert {k for k in want if k.startswith("vit.blocks.2.")} == {
        k for k in got if k.startswith("vit.blocks.2.")} != set()
    assert got.keys() == want.keys()
    for k, shape in want.items():
        assert int(np.prod(got[k])) == int(np.prod(shape)), k
