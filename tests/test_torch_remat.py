"""Rematerialization (``loftr.remat``) in the port's training step, on the
CPU at the tiny configurations of tests/torch_parity.py:

* one step of 4c, 2c, the indoor recipe, quadtree_baseline, the PMT
  refine model (with the detector head) and the zoo's Z1-Z3 (the self
  layers local_global, LKA, topk and linear), remat on and off, from the
  same weights and batch: the loss terms, the gradients, the BatchNorm
  running statistics and the EMA parameters bit-equal (the recompute is
  the same float32 CPU graph);
* the wrapped set is the JAX package's (``nn.remat`` around every layer of
  ``LocalFeatureTransformer`` and ``CascadeFeatureTransformer`` but
  LKABlock): with remat each such layer's ``forward`` is entered twice per
  step where it runs once without; LKABlock, the detector head and the
  refine model's frozen trunk (under no_grad) once;
* the eval forward is the same with remat on and off, bit for bit;
* the 4c step against the JAX step is tests/test_torch_train.py's
  (``step_run``), with remat on in both packages by default: checked
  here, so that its tolerances hold the rematerialized step;
* test_torch_train's pair shifted by 8 px through the indoor and the
  baseline steps, the baseline at the recipe's coarse threshold 0.2, each
  against the JAX step within test_torch_train's tolerances and with a
  fine loss above 0.  The indoor and baseline tests of their own files
  run the identity pair and the coarse threshold 0, where the fine loss
  on a shifted pair had no check; the weight seeds here (5 and 3) give
  the tiny random models matches inside the fine windows on this pair
  (indoor seeds 1-4 give none).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from casmtr_tpu_torch.configs import build_config  # noqa: E402
from casmtr_tpu_torch.models import build_model  # noqa: E402
from casmtr_tpu_torch.models.cascade_attention import (  # noqa: E402
    DoubleGroupBlock, LKABlock, LocalBlock)
from casmtr_tpu_torch.models.cascade_transformer import (  # noqa: E402
    CascadeFeatureTransformer, CascadeQuadtreeBlock)
from casmtr_tpu_torch.models.casmtr_refine import \
    frozen_param_label  # noqa: E402
from casmtr_tpu_torch.models.pola import POLATransBlock  # noqa: E402
from casmtr_tpu_torch.models.transformer import (  # noqa: E402
    LocalFeatureTransformer, LoFTREncoderLayer, QuadtreeBlock)
from casmtr_tpu_torch.train.train_step import (  # noqa: E402
    init_train_state, make_train_step)
from casmtr_tpu_torch.weights import init_random_  # noqa: E402
from tests.test_torch_quadtree_loftr import grad_errors  # noqa: E402
from tests.test_torch_refine import DETECTOR, tiny_refine_overrides  # noqa
from tests.test_torch_train import _leaves as leaves  # noqa: E402
from tests.test_torch_train import (_pair_batch, jax_step,  # noqa: E402
                                    step_variables, torch_step)
from tests.torch_parity import (configs, tiny_2c_overrides,  # noqa: E402
                                tiny_4c_overrides, tiny_baseline_overrides,
                                tiny_indoor_overrides, tiny_zoo_overrides)

SIZE = 64
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
WRAPPED = (LoFTREncoderLayer, QuadtreeBlock, DoubleGroupBlock, LocalBlock,
           POLATransBlock, CascadeQuadtreeBlock)


def _no_double_check(ov, levels=1):
    """The 1/4 (and 1/2) double check off, so that the random models keep
    cascade matches for the cascade and fine losses."""
    ov["loftr"].setdefault("match_cascade", {})["double_check"] = \
        [False] * levels
    return ov


def _refine():
    ov = _no_double_check(tiny_refine_overrides())
    ov["loftr"]["coarse2"].update(DETECTOR)
    return "indoor_casmtr_4c", ov


CASES = {
    "4c": lambda: ("outdoor_casmtr_4c",
                   _no_double_check(tiny_4c_overrides(SIZE))),
    "2c": lambda: ("outdoor_casmtr_2c",
                   _no_double_check(tiny_2c_overrides(SIZE), 2)),
    "indoor": lambda: ("indoor_casmtr_4c_runnable",
                       _no_double_check(tiny_indoor_overrides(SIZE))),
    "baseline": lambda: ("quadtree_baseline", tiny_baseline_overrides(SIZE)),
    "refine": _refine,
    **{z: (lambda z=z: (lambda r, ov: (r, _no_double_check(
        ov, 2 if r.endswith("2c") else 1)))(*tiny_zoo_overrides(z, SIZE)))
       for z in ("Z1", "Z2", "Z3")},
}


def _stack_layers(model):
    """(name, layer, runs under grad) of every stack layer and detector
    head of ``model``."""
    refine = hasattr(model, "ladder") or hasattr(model, "proj4c")
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, (LocalFeatureTransformer,
                            CascadeFeatureTransformer)):
            trunk = refine and name == "loftr_coarse"
            out += [(f"{name}.layers.{i}", layer, not trunk)
                    for i, layer in enumerate(mod.layers)]
            if getattr(mod, "detector", None) is not None:
                out.append((f"{name}.detector", mod.detector, True))
    return out


def _step(recipe, ov, remat, seed=1):
    """One training step on the CPU with ``loftr.remat`` set: (scalars,
    gradients, buffers, EMA parameters, forward entries per stack layer,
    the model)."""
    ov = {**ov, "loftr": {**ov["loftr"], "remat": remat},
          "trainer": {"ema": True, "warmup_step": 0}}
    cfg = build_config(recipe, overrides=ov)
    refine = recipe == "indoor_casmtr_4c" and "refine_dims" in str(ov)
    model = build_model(cfg.loftr, refine=refine)
    init_random_(model, torch.Generator().manual_seed(seed))
    entries = {}
    for name, layer, _ in _stack_layers(model):
        layer.register_forward_pre_hook(
            lambda m, a, name=name: entries.__setitem__(
                name, entries.get(name, 0) + 1))
    state, tx = init_train_state(
        model, cfg, 100, 1e-3, device="cpu",
        frozen_label_fn=frozen_param_label if refine else None)
    state, scalars = make_train_step(model, cfg, tx, device="cpu")(
        state, _pair_batch(size=SIZE))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return scalars, grads, buffers, state.ema_params, entries, model


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    recipe, ov = CASES[request.param]()
    return request.param, recipe, ov, _step(recipe, ov, True), \
        _step(recipe, ov, False)


def test_remat_step_is_bit_equal(pair):
    _, _, _, on, off = pair
    assert set(on[0]) == set(off[0])
    for k in on[0]:
        assert float(on[0][k]) == float(off[0][k]), k
    assert float(on[0]["loss"]) > 0
    for part in (1, 2, 3):
        assert on[part].keys() == off[part].keys()
        for k in on[part]:
            torch.testing.assert_close(on[part][k], off[part][k], rtol=0,
                                       atol=0, msg=k)
    assert len(on[1]) > 0 and on[3] is not None


def test_remat_wraps_the_jax_set(pair):
    name, _, _, on, off = pair
    layers = _stack_layers(on[5])
    kinds = set()
    for lname, layer, grad in layers:
        n_on, n_off = on[4].get(lname, 0), off[4].get(lname, 0)
        assert n_off > 0, lname
        wrapped = grad and isinstance(layer, WRAPPED)
        assert n_on == (2 * n_off if wrapped else n_off), (lname, n_on,
                                                            n_off)
        kinds.add((type(layer).__name__, wrapped))
    if name == "Z2":
        assert ("LKABlock", False) in kinds
    if name == "refine":
        assert ("Sequential", False) in kinds        # the detector head
        assert ("QuadtreeBlock", False) in kinds     # the frozen trunk
    if name == "Z1":
        assert ("DoubleGroupBlock", True) in kinds
    if name == "Z3":
        assert {("QuadtreeBlock", True),
                ("LoFTREncoderLayer", True)} <= kinds


@pytest.mark.parametrize("case", ["4c", "indoor"])
def test_remat_leaves_the_eval_forward(case):
    recipe, ov = CASES[case]()
    outs = []
    for remat in (True, False):
        cfg = build_config(recipe, overrides={
            **ov, "loftr": {**ov["loftr"], "remat": remat}})
        model = build_model(cfg.loftr)
        init_random_(model, torch.Generator().manual_seed(0))
        model.eval()
        batch = {k: torch.from_numpy(v) for k, v in
                 _pair_batch(size=SIZE).items()
                 if k in ("image0", "image1")}
        fm = model(batch).final_matches
        outs.append({k: getattr(fm, k) for k in ("mkpts0", "mkpts1",
                                                 "mconf", "valid")})
    for k in outs[0]:
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


def _against_jax(recipe, ov, batch, seed):
    jcfg, tcfg = configs(ov, recipe)
    assert jcfg.loftr.remat and tcfg.loftr.remat
    jm, like, variables = step_variables(jcfg, tcfg, batch, seed=seed)
    js, jg, jstats = jax_step(jm, jcfg, variables, batch, two_pass_bn=True)
    ts, tg, tstats = torch_step(tcfg, variables, like, batch)
    assert set(ts) == set(js)
    for k in js:
        if k.startswith("valid_n"):
            assert int(ts[k]) == int(js[k]), k
        else:
            np.testing.assert_allclose(float(ts[k]), float(js[k]),
                                       rtol=STEP_LOSS_RTOL, err_msg=k)
    want, got = leaves(jg), leaves(tg)
    assert got.keys() == want.keys()
    for k, err in grad_errors(got, want).items():
        assert np.isfinite(got[k]).all(), k
        assert err <= GRAD_RTOL, f"{k}: relative error {err}"
    wstats, gstats = leaves(jstats), leaves(tstats)
    for k, w in wstats.items():
        np.testing.assert_allclose(gstats[k], w, rtol=0, atol=BN_ATOL,
                                   err_msg=k)
    return ts


def test_the_4c_step_parity_runs_with_remat():
    from tests.test_torch_train import _step_overrides
    jcfg, tcfg = configs(_step_overrides())
    assert jcfg.loftr.remat and tcfg.loftr.remat
    model = build_model(tcfg.loftr)
    stacks = [m for m in model.modules()
              if isinstance(m, (LocalFeatureTransformer,
                                CascadeFeatureTransformer))]
    assert len(stacks) == 3 and all(m.remat for m in stacks)


def test_shifted_indoor_step_has_a_fine_loss_and_matches_jax():
    recipe, ov = CASES["indoor"]()
    ts = _against_jax(recipe, ov, _pair_batch(size=SIZE, shift=8), seed=5)
    assert float(ts["loss_4c"]) > 0 and float(ts["loss_f"]) > 0


def test_shifted_baseline_step_at_the_recipe_threshold_matches_jax():
    recipe, ov = CASES["baseline"]()
    cfg = build_config(recipe, overrides=ov)
    assert cfg.loftr.match_coarse.thr == pytest.approx(0.2)
    ts = _against_jax(recipe, ov, _pair_batch(size=SIZE, shift=8), seed=3)
    assert float(ts["loss_f"]) > 0
