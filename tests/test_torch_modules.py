"""Modules of the PyTorch port against their flax counterparts, with the
flax variables carried across by ``load_jax_variables``: the Twins-FPN
backbone, one quadtree block, the coarse and fine transformer stacks, the
cascade transformer and the coarse matching head.  Tolerance atol 1e-4: the
same float32 arithmetic, summed in another order by XLA-CPU and ATen."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (configs, flax_like, jitter,  # noqa: E402
                                port_variables, tiny_4c_overrides)

ATOL = 1e-4


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _load(module, variables):
    from casmtr_tpu_torch.weights import load_jax_variables
    load_jax_variables(module, variables)
    return module.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def _init_apply(module, port, seed, *args):
    """Jittered variables of the port module ``port``'s seeded weights on
    the flax init's tree (traced, not compiled: ``port_variables``) and
    the jitted apply; static arguments (grid sizes) are closed over."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def call(fn):
        def run(first, *xs):
            full = list(args)
            for i, x in zip(arrays, xs):
                full[i] = x
            return fn(first, *full)
        return run

    xs = [args[i] for i in arrays]
    variables = port_variables(port, lambda: call(module.init)(
        jax.random.PRNGKey(seed), *xs), seed=seed)
    return variables, jax.jit(call(module.apply))(variables, *xs)


@pytest.fixture(scope="module")
def cfgs():
    return configs(tiny_4c_overrides())


@pytest.mark.parametrize("hw", [(64, 96), (70, 90)])
def test_twins_fpn_matches_flax(hw):
    """Twins-small FPN at tiny dims.  64x96 pads only the right of the 7x7
    attention windows at 1/4; 70x90 is divisible by no stride, pinning the
    floor (VALID) padding of the patch-embedding and sr convs."""
    from casmtr_tpu.models.backbone.twins import TwinsFPN_8_4_2 as JaxTwins
    from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_8_4_2
    x = np.random.default_rng(0).random((2,) + hw + (3,)).astype(np.float32)
    jm = JaxTwins(initial_dim=8, block_dims=(8, 12, 16), model_type="small")
    tm = TwinsFPN_8_4_2(8, (8, 12, 16), "small")
    variables, want = _init_apply(jm, tm, 0, jnp.asarray(x))
    _load(tm, variables)
    with torch.inference_mode():
        got = tm(_t(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)


def test_quadtree_block_matches_flax():
    from casmtr_tpu.models.transformer import QuadtreeBlock as JaxBlock
    from casmtr_tpu_torch.models.transformer import QuadtreeBlock
    rng = np.random.default_rng(1)
    hw = (16, 12)
    x, t = (rng.standard_normal((2, 192, 16)).astype(np.float32)
            for _ in range(2))
    jm = JaxBlock(16, 2, (4, 4, 4), scale=3)
    tm = QuadtreeBlock(16, 2, (4, 4, 4), 3)
    variables, want = _init_apply(jm, tm, 1, jnp.asarray(x), jnp.asarray(t),
                                  hw, hw)
    _load(tm, variables)
    with torch.inference_mode():
        got = tm(_t(x), _t(t), hw, hw)
    _close(got, want)


@pytest.mark.parametrize("stack", ["coarse", "fine"])
def test_local_feature_transformer_matches_flax(cfgs, stack):
    """The quadtree stack at 1/8 (simultaneous cross updates) and the
    'loftr' fine stack with full attention (sequential cross updates), the
    latter with padding masks."""
    from casmtr_tpu.models.transformer import \
        LocalFeatureTransformer as JaxLFT
    from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(2)
    if stack == "coarse":
        hw, C, masks = (16, 16), 16, (None, None)
    else:
        hw, C = (5, 5), 8
        m = np.ones((2, 25), np.float32)
        m[1, 20:] = 0.0
        masks = (m, m[::-1].copy())
    L = hw[0] * hw[1]
    f0, f1 = (rng.standard_normal((2, L, C)).astype(np.float32)
              for _ in range(2))
    jm = JaxLFT(getattr(jcfg.loftr, stack), 128, remat=False)
    jargs = (jnp.asarray(f0), jnp.asarray(f1), hw, hw) + tuple(
        None if m is None else jnp.asarray(m) for m in masks)
    tm = LocalFeatureTransformer(getattr(tcfg.loftr, stack))
    variables, want = _init_apply(jm, tm, 2, *jargs)
    _load(tm, variables)
    with torch.inference_mode():
        got = tm(_t(f0), _t(f1), hw, hw,
                 *(None if m is None else _t(m) for m in masks))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_cascade_feature_transformer_matches_flax(cfgs):
    """1/4 cascade stack: window cross layers (kernel C on the card) around
    boundary-shifted windows, and LocalBlock self layers."""
    from casmtr_tpu.models.cascade_transformer import \
        CascadeFeatureTransformer as JaxCFT
    from casmtr_tpu_torch.models.cascade_transformer import \
        CascadeFeatureTransformer
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(3)
    hw0, hw1 = (16, 20), (16, 20)
    f0, f1 = (rng.standard_normal((1, 320, 12)).astype(np.float32)
              for _ in range(2))
    idx01, idx10 = (rng.integers(0, 80, (1, 80)).astype(np.int32)
                    for _ in range(2))
    jm = JaxCFT(jcfg.loftr.coarse2, 32, remat=False, train_mode=False)
    jargs = (jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(idx01),
             jnp.asarray(idx10), hw0, hw1)
    tm = CascadeFeatureTransformer(tcfg.loftr.coarse2)
    variables, want = _init_apply(jm, tm, 3, *jargs)
    _load(tm, variables)
    with torch.inference_mode():
        got = tm(_t(f0), _t(f1), _t(idx01).long(), _t(idx10).long(), hw0,
                 hw1)
    _close(got[0], want[0])
    _close(got[1], want[1])
    for g, w in ((got[2], want[2]), (got[3], want[3]), (got[4], want[5]),
                 (got[5], want[6])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("masked", [False, True])
def test_coarse_matching_matches_jax(masked):
    """dual_softmax + extract_coarse_matches: threshold, mutual nearest
    neighbour, padding and border removal, fixed capacity."""
    from casmtr_tpu.ops import matching as jm
    from casmtr_tpu_torch.ops import matching as tm
    rng = np.random.default_rng(4)
    hw = (8, 10)
    f0, f1 = (rng.standard_normal((2, 80, 16)).astype(np.float32)
              for _ in range(2))
    f1[:, :40] = f0[:, :40] + 0.1 * f1[:, :40]  # plenty of mutual matches
    m0 = m1 = m0f = m1f = None
    if masked:
        m0 = np.ones((2, 8, 10), np.float32)
        m0[1, 6:] = 0.0
        m1 = np.ones((2, 8, 10), np.float32)
        m1[0, :, 7:] = 0.0
        m0f, m1f = m0.reshape(2, -1), m1.reshape(2, -1)
    scale = np.asarray([[1.5, 2.0], [1.0, 0.5]], np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else _t(a)  # noqa: E731
    jd = jm.dual_softmax(j(f0), j(f1), 0.1, j(m0f), j(m1f))
    td = tm.dual_softmax(t(f0), t(f1), 0.1, t(m0f), t(m1f))
    _close(td.conf_matrix, jd.conf_matrix, atol=1e-5)
    for name in ("next_idx_c01", "next_idx_c10"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    jmt = jm.extract_coarse_matches(jd.conf_matrix, 0.01, 1, hw, hw, 24, 8.0,
                                    mask0=j(m0), mask1=j(m1), scale0=j(scale),
                                    scale1=j(scale))
    tmt = tm.extract_coarse_matches(td.conf_matrix, 0.01, 1, hw, hw, 24, 8.0,
                                    mask0=t(m0), mask1=t(m1), scale0=t(scale),
                                    scale1=t(scale))
    assert int(tmt.valid.sum()) > 0
    v = np.asarray(jmt.valid)
    np.testing.assert_array_equal(tmt.valid.numpy(), v)
    for name in ("b_ids", "i_ids", "j_ids"):
        np.testing.assert_array_equal(getattr(tmt, name).numpy()[v],
                                      np.asarray(getattr(jmt, name))[v])
    for name in ("mconf", "mkpts0", "mkpts1"):
        _close(getattr(tmt, name).numpy()[v],
               np.asarray(getattr(jmt, name))[v], atol=1e-5)


@pytest.fixture(scope="module")
def model_variables(cfgs):
    """Variables of the whole tiny 4c model: the flax init's tree (traced,
    not compiled), every leaf jittered into noise of its own, so each
    mapped value shows where it lands."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    model = JaxCasMTR(cfgs[0].loftr)
    return jitter(flax_like(lambda: model.init(
        jax.random.PRNGKey(4), {"image0": img, "image1": img},
        train=False)), seed=4)


def test_load_jax_variables_fills_every_key(cfgs, model_variables):
    """Every parameter and buffer of the whole 4c model is filled, with the
    values in torch layout (a Dense kernel transposed, a conv HWIO->OIHW)."""
    from casmtr_tpu_torch.models.casmtr import CasMTR
    variables = model_variables
    model = _load(CasMTR(cfgs[1].loftr), variables)
    sd = model.state_dict()
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["loftr_coarse_8c.layers.0.attn.q_proj.weight"].numpy()[:, :, 0, 0],
        p["loftr_coarse_8c"]["layers_0"]["attn"]["q_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["backbone.conv1.0.weight"].numpy(),
        p["backbone"]["conv1_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["up_block1.inner.1.running_var"].numpy(),
        variables["batch_stats"]["up_block1"]["inner_1"]["var"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_variables_is_strict(cfgs, model_variables, fault):
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    variables = copy.deepcopy(model_variables)
    up = variables["params"]["up_block1"]
    if fault == "missing":
        del up["up_0"]
    elif fault == "extra":
        up["spare"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        up["up_0"]["kernel"] = up["up_0"]["kernel"][:, :, :-1]
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(CasMTR(cfgs[1].loftr), variables)
