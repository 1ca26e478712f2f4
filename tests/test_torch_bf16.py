"""The port's bf16 eval policy against the JAX package's, on the CPU.

* The policy functions: ``backbone_dtype`` takes bf16 on the card in eval
  and in training, ``transformer_dtype`` bf16 on the card in eval and
  float32 in training, both float32 on the CPU, and
  ``CASMTR_BACKBONE_BF16`` / ``CASMTR_TRANSFORMER_BF16`` force either dtype;
  ``table_dtype`` (the gather tables of kernels A, A′ and C) is bf16 on the
  card in both modes and float32 on the CPU (tests/test_torch_bf16_train.py
  covers its environment rule).  No card is needed: ``torch.device("cuda")``
  objects are enough.
* The plain versions of kernels A, A′ and C on bf16 q/k/v against the JAX
  package's Pallas kernels on the same bf16 inputs, in interpret mode.  C
  computes in float32 on the bf16 values in both, so they agree within
  1e-5.  The Pallas A/A′ kernel also rounds q * scale and the softmax
  probabilities to bf16 (its MXU layout), so the port's A/A′ are held
  within 5e-3 of it, and within 1e-5 of the Pallas kernel run in float32 on
  the bf16-rounded inputs (the contract the CUDA instances follow); A′'s
  top-k scores within 1e-5 of the bf16 kernel's, index sets equal off near
  ties.  The same holds for quadtree attention B and its cascade form on
  bf16 tables.
* The Twins backbone, the 1/8 stack and the 1/4 cascade stack with both
  environment variables set, against the JAX package with the same
  environment: within 2e-2 of the largest output value, and nearer to the
  JAX bf16 output than to the JAX float32 one (RMS), so the test tells the
  two policies apart.  After a bf16 forward every parameter and buffer is
  still float32.
  The JAX side is compiled with XLA's excess precision off (``_exact``),
  so it rounds at every flax module boundary, as the port does.  The
  backbone lies less far inside the bf16 rounding noise than the stacks,
  because the port's GELU and bilinear resize round once (as a fused
  elementwise chain does on the card) where the JAX CPU graph rounds
  after each jnp operation.
* The tiny 4c and 2c eval forwards under the same environment, at every
  stage, against the JAX bf16 forward, within the JAX package's own
  bf16-against-float32 difference (the tiny model's dual softmax turns
  rounding into large moves; the test states the bounds).
* The kernels' argument limits for bf16 (dtype, mixed dtypes, odd widths,
  alignment), which raise before any CUDA call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops import quadtree as jqt  # noqa: E402
from casmtr_tpu.ops.pallas.quadtree_kernels import \
    masked_fine_level  # noqa: E402
from casmtr_tpu.ops.pallas.window_kernels import \
    window_cross_attention as jax_wca  # noqa: E402
from casmtr_tpu_torch.ops import quadtree as tqt  # noqa: E402
from casmtr_tpu_torch.ops.kernels import quadtree_kernels as tqk  # noqa
from casmtr_tpu_torch.ops.kernels import window_kernels as twk  # noqa: E402
from tests.test_torch_slice import _by_pair, _fields, _images  # noqa: E402
from tests.torch_parity import (configs, jitter, port_variables,  # noqa
                                tiny_2c_overrides, tiny_4c_overrides)

ENV = ("CASMTR_BACKBONE_BF16", "CASMTR_TRANSFORMER_BF16")
KERNEL_ATOL = 1e-5     # float32 sums of the same bf16 values, another order
PALLAS_BF16_ATOL = 5e-3  # the Pallas A/A′ rounds q*scale and p to bf16
SCORE_ATOL = 1e-5      # A′'s top-k probabilities
TIE_GAP = 1e-5         # rows whose k-th and (k+1)-th scores are this close
MODULE_RTOL = 2e-2     # bf16 stacks: of the largest output value
# the whole bf16 forward, per stage (see test_bf16_eval_forward_matches_jax)
MAX_JACCARD = 0.95     # the match sets' Jaccard need not exceed this ...
JACCARD_SLACK = 0.1    # ... less this, nor the JAX package's own less this
CONF_ATOL = 1e-2       # common matches' confidences, or NOISE_FACTOR times
PX_ATOL = 5e-2         # the JAX package's own error, whichever is larger
NOISE_FACTOR = 1.5


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    """The same numpy float32 array rounded to bf16 by both packages."""
    return torch.from_numpy(np.asarray(x)).bfloat16(), jnp.asarray(
        x, jnp.bfloat16)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.fixture
def bf16_env(monkeypatch):
    for name in ENV:
        monkeypatch.setenv(name, "1")


@pytest.fixture
def no_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


# --------------------------------------------------------------------------
# the policy functions
# --------------------------------------------------------------------------

def _policies():
    from casmtr_tpu_torch.models.backbone.resnet_fpn import backbone_dtype
    from casmtr_tpu_torch.models.transformer import transformer_dtype
    return {"CASMTR_BACKBONE_BF16": backbone_dtype,
            "CASMTR_TRANSFORMER_BF16": transformer_dtype}


@pytest.mark.parametrize("env", ENV)
def test_policy_defaults_follow_device_and_mode(no_env, env):
    fn = _policies()[env]
    # the backbone trains in bf16 on the card, the stacks in float32
    train = (torch.bfloat16 if env == "CASMTR_BACKBONE_BF16"
             else torch.float32)
    assert fn(torch.device("cuda"), False) == torch.bfloat16
    assert fn(torch.device("cuda", 0), False) == torch.bfloat16
    assert fn("cuda", True) == train
    assert fn(torch.device("cpu"), False) == torch.float32
    assert fn(torch.device("cpu"), True) == torch.float32


@pytest.mark.parametrize("env", ENV)
@pytest.mark.parametrize("value,dtype", [("1", torch.bfloat16),
                                         ("0", torch.float32)])
def test_policy_env_forces_either_dtype(monkeypatch, env, value, dtype):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(env, value)
    fn = _policies()[env]
    for device in ("cuda", "cpu"):
        for train in (False, True):
            assert fn(torch.device(device), train) == dtype
    other = [e for e in ENV if e != env][0]   # each reads its own variable
    assert _policies()[other](torch.device("cpu"), False) == torch.float32


def test_table_dtype_follows_device_and_mode_only(bf16_env):
    from casmtr_tpu_torch.models.transformer import table_dtype
    bf16, f32 = torch.bfloat16, torch.float32
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert table_dtype(cuda) == bf16   # in eval and in training
    assert table_dtype(cpu) == f32     # the JAX CPU graph


# --------------------------------------------------------------------------
# kernels A, A′ and C on bf16 q/k/v
# --------------------------------------------------------------------------

def _fine_case(seed, B, H, D, hw, K):
    """Unit-normal q/k/v and distinct block ids (the Pallas kernel's
    precondition)."""
    rng = np.random.default_rng(seed)
    L, Lb = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    ids = np.stack([np.stack([np.stack(
        [rng.choice(Lb, size=K, replace=False) for _ in range(H)], -1)
        for _ in range(Lb)]) for _ in range(B)]).astype(np.int32)
    return q, k, v, ids


@pytest.mark.parametrize("B,H,D,hw,K,topk", [
    (2, 2, 16, (8, 8), 3, 0),       # kernel A
    (1, 2, 8, (8, 8), 3, 4),        # kernel A′
])
def test_quadtree_fine_plain_on_bf16_matches_pallas(B, H, D, hw, K, topk):
    q, k, v, ids = _fine_case(B + H + K, B, H, D, hw, K)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(k), _bf16(v)
    args = (_t(ids), hw, hw)
    pallas_bf16 = masked_fine_level(jq, jk, jv, jnp.asarray(ids), hw, hw,
                                    topk=topk, interpret=True)
    pallas_f32 = masked_fine_level(
        *(x.astype(jnp.float32) for x in (jq, jk, jv)), jnp.asarray(ids), hw,
        hw, topk=topk, interpret=True)
    if not topk:
        msg = tqk.quadtree_fine_attention_plain(tq, tk, tv, *args)
        assert msg.dtype == torch.float32
        _close(msg, pallas_bf16[0], PALLAS_BF16_ATOL)
        _close(msg, pallas_f32[0], KERNEL_ATOL)
        return
    n = min(topk + 1, 4 * K)
    msg, score, idx = tqk.quadtree_fine_topk_plain(tq, tk, tv, *args, n)
    assert msg.dtype == score.dtype == torch.float32
    _close(msg, pallas_bf16[0], PALLAS_BF16_ATOL)
    _close(msg, pallas_f32[0], KERNEL_ATOL)
    want_s, want_i = (np.asarray(x) for x in pallas_bf16[1:])
    _close(np.sort(score.numpy()[:, :, :topk], axis=2),
           np.sort(want_s, axis=2), SCORE_ATOL)
    clear = (np.ones(score.shape[:2] + score.shape[3:], bool) if n == topk
             else (score[:, :, topk - 1] - score[:, :, topk]).numpy()
             > TIE_GAP)
    same = (np.sort(idx.numpy()[:, :, :topk], axis=2)
            == np.sort(want_i, axis=2)).all(axis=2)
    assert clear.mean() > 0.9
    assert same[clear].all()


@pytest.mark.parametrize("H,D,grid,w", [(4, 32, 8, 2), (2, 8, 12, 3)])
def test_window_cross_attention_plain_on_bf16_matches_pallas(H, D, grid, w):
    rng = np.random.default_rng(H * D)
    L = grid * grid
    q, k, v = (rng.standard_normal((1, L, H, D)).astype(np.float32)
               for _ in range(3))
    corners = rng.integers(0, grid // 2 - w + 1, (1, L // 4, 2)
                           ).astype(np.int32)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(k), _bf16(v)
    hw = (grid, grid)
    got = twk.window_cross_attention_plain(tq, tk, tv, _t(corners), hw, hw,
                                           w)
    want = jax_wca(jq, jk, jv, jnp.asarray(corners), hw, hw, w, True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, KERNEL_ATOL)


def test_qtatt_b_and_cascade_form_on_bf16_tables_match_jax():
    """Quadtree attention B on a bf16 pyramid (the coarse level's scores
    and message in float32) and the structured cascade cross-attention on
    bf16 q/k/v, against the JAX package's gather paths on the same bf16
    tables."""
    rng = np.random.default_rng(11)
    sizes, H, D = [(16, 16), (8, 8), (4, 4)], 2, 8
    pyr = [[_bf16(rng.standard_normal((1, h * w, H, D)).astype(np.float32))
            for h, w in sizes] for _ in range(3)]
    wt = rng.standard_normal(3).astype(np.float32)
    got = tqt.qtatt_b(*([t for t, _ in lv] for lv in pyr), sizes, [4, 3, 2],
                      _t(wt))
    want = jqt.qtatt_b(*([j for _, j in lv] for lv in pyr), sizes, [4, 3, 2],
                       jnp.asarray(wt))
    assert got.dtype == torch.float32
    _close(got, want, KERNEL_ATOL)

    G, w = 12, 3
    (tq, jq), (tk, jk), (tv, jv) = (
        _bf16(rng.standard_normal((1, G * G, H, D)).astype(np.float32))
        for _ in range(3))
    from casmtr_tpu.models.cascade_transformer import window_warp_idx
    from casmtr_tpu.ops.propagation import get_propagations
    prev = rng.integers(0, (G // 2) ** 2, (1, (G // 2) ** 2)).astype(np.int32)
    win, _ = window_warp_idx(jnp.asarray(prev), get_propagations("window",
                                                                 w)[0],
                             G // 2, G // 2)
    want_m, _ = jqt.cascade_qtatt_b(jq, jk, jv, win, (G, G), (G, G),
                                    window_structured=True)
    got_m, _ = tqt.cascade_qtatt_b(tq, tk, tv, _t(np.asarray(win)).long(),
                                   (G, G), (G, G), window_structured=True)
    _close(got_m, want_m, KERNEL_ATOL)


def test_bf16_kernel_limits_raise_before_any_cuda_call():
    """The wrappers' argument checks that need no card: the dtype, mixed
    dtypes, widths the bf16 instances do not take and misaligned bf16
    pointers raise ValueError; valid bf16 inputs pass them and stop only at
    the device check."""
    hw, ids = (8, 8), torch.zeros((1, 16, 2, 2), dtype=torch.int32)
    corners = torch.zeros((1, 16, 2), dtype=torch.int32)

    def qkv(D, dtype, H=2, offset=0):
        n = 64 * H * D
        t = torch.zeros(n + offset, dtype=dtype)[offset:].view(1, 64, H, D)
        return t, t.clone(), t.clone()

    def quadtree(q, k, v):
        tqk._check(q, k, v, ids, hw, hw)

    def window(q, k, v):
        twk._check_wca(q, k, v, corners, hw, hw, 2)

    for check in (quadtree, window):
        q, k, v = qkv(8, torch.bfloat16)
        with pytest.raises(ValueError, match="share one dtype"):
            check(q, k.float(), v)
        with pytest.raises(ValueError, match="dtype torch.float16"):
            check(*qkv(8, torch.float16))
        with pytest.raises(ValueError, match="4-byte aligned"):
            check(*qkv(8, torch.bfloat16, offset=1))
        with pytest.raises(ValueError, match="at most 512"):
            check(*qkv(6, torch.bfloat16, H=100))
        for ok in (qkv(8, torch.bfloat16), qkv(6, torch.bfloat16, offset=2),
                   qkv(5, torch.float32)):
            with pytest.raises(ValueError, match="CUDA"):
                check(*ok)
    with pytest.raises(ValueError, match="even head width"):
        quadtree(*qkv(5, torch.bfloat16))
    with pytest.raises(ValueError, match="even row width"):
        window(*qkv(5, torch.bfloat16, H=1))


# --------------------------------------------------------------------------
# the bf16 stacks against the JAX package's
# --------------------------------------------------------------------------

def _exact(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with XLA's excess precision off.  By
    default XLA's CPU compiler may keep a fused chain of bf16 operations in
    float32 and skip the roundings between them (a conv's output feeding its
    BatchNorm, say); with the option off it rounds wherever flax's
    per-module dtype says, as the port and the card do.  The JAX package is
    unchanged."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _jax_run(module, seed, args, env, monkeypatch, variables=None):
    """Jitted flax init (jittered) and apply (``_exact``) under the
    environment ``env`` ("1": bf16 stacks, None: the CPU default), grid
    sizes closed over."""
    for name in ENV:
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    arrays = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def call(fn):
        def run(first, *xs):
            full = list(args)
            for i, x in zip(arrays, xs):
                full[i] = x
            return fn(first, *full)
        return run

    xs = [args[i] for i in arrays]
    if variables is None:
        variables = jitter(jax.jit(call(module.init))(
            jax.random.PRNGKey(seed), *xs), seed=seed)
    return variables, _exact(call(module.apply), variables, *xs)


def _hold_to_bf16_policy(module, port_args, jax_module, seed, jargs,
                         monkeypatch, outputs):
    """The port module under the bf16 environment against the JAX module
    under the same environment and under the float32 default, from the same
    jittered variables: each output in ``outputs`` within MODULE_RTOL of the
    largest value of the JAX bf16 output, and nearer to it than to the JAX
    float32 output (RMS).  The module's parameters and buffers stay
    float32."""
    from casmtr_tpu_torch.weights import load_jax_variables
    variables, want_f32 = _jax_run(jax_module, seed, jargs, None,
                                   monkeypatch)
    _, want_bf16 = _jax_run(jax_module, seed, jargs, "1", monkeypatch,
                            variables)
    load_jax_variables(module, variables)
    module.eval()
    with torch.inference_mode():   # the environment is still "1"
        got = module(*port_args)
    for i in outputs:
        assert got[i].dtype == torch.float32
        g = got[i].numpy()
        if g.shape != np.shape(want_bf16[i]):
            g = g.transpose(0, 2, 3, 1)    # NCHW -> NHWC
        wb = np.asarray(want_bf16[i], np.float32)
        wf = np.asarray(want_f32[i], np.float32)
        err = np.abs(g - wb).max()
        assert err <= MODULE_RTOL * np.abs(wb).max(), (i, err)
        rms_b = np.sqrt(np.mean((g - wb) ** 2))
        rms_f = np.sqrt(np.mean((g - wf) ** 2))
        assert rms_b < rms_f, (i, rms_b, rms_f)
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        assert t.dtype in (torch.float32, torch.int64), name


@pytest.fixture(scope="module")
def cfgs():
    return configs(tiny_4c_overrides())


def test_twins_fpn_bf16_matches_jax(monkeypatch):
    from casmtr_tpu.models.backbone.twins import TwinsFPN_8_4_2 as JaxTwins
    from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_8_4_2
    x = np.random.default_rng(0).random((2, 64, 96, 3)).astype(np.float32)
    _hold_to_bf16_policy(
        TwinsFPN_8_4_2(8, (8, 12, 16), "small"),
        (_t(x).permute(0, 3, 1, 2),),
        JaxTwins(initial_dim=8, block_dims=(8, 12, 16), model_type="small"),
        0, (jnp.asarray(x),), monkeypatch, (0, 1, 2))


def test_coarse_stack_bf16_matches_jax(monkeypatch, cfgs):
    from casmtr_tpu.models.transformer import \
        LocalFeatureTransformer as JaxLFT
    from casmtr_tpu_torch.models.transformer import LocalFeatureTransformer
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(2)
    hw = (16, 16)
    f0, f1 = (rng.standard_normal((2, 256, 16)).astype(np.float32)
              for _ in range(2))
    _hold_to_bf16_policy(
        LocalFeatureTransformer(tcfg.loftr.coarse),
        (_t(f0), _t(f1), hw, hw),
        JaxLFT(jcfg.loftr.coarse, 128, remat=False), 2,
        (jnp.asarray(f0), jnp.asarray(f1), hw, hw), monkeypatch, (0, 1))


def test_cascade_stack_bf16_matches_jax(monkeypatch, cfgs):
    from casmtr_tpu.models.cascade_transformer import \
        CascadeFeatureTransformer as JaxCFT
    from casmtr_tpu_torch.models.cascade_transformer import \
        CascadeFeatureTransformer
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(3)
    hw = (16, 20)
    f0, f1 = (rng.standard_normal((1, 320, 12)).astype(np.float32)
              for _ in range(2))
    idx01, idx10 = (rng.integers(0, 80, (1, 80)).astype(np.int32)
                    for _ in range(2))
    _hold_to_bf16_policy(
        CascadeFeatureTransformer(tcfg.loftr.coarse2),
        (_t(f0), _t(f1), _t(idx01).long(), _t(idx10).long(), hw, hw),
        JaxCFT(jcfg.loftr.coarse2, 32, remat=False, train_mode=False), 3,
        (jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(idx01),
         jnp.asarray(idx10), hw, hw), monkeypatch, (0, 1))


# --------------------------------------------------------------------------
# the whole bf16 eval forward
# --------------------------------------------------------------------------

def _stage_errors(got, want):
    """(Jaccard of the valid (b, i, j) sets, max confidence error and max
    keypoint error in px over the common matches)."""
    keys_g, vals_g = _by_pair(got)
    keys_w, vals_w = _by_pair(want)
    common = sorted(set(keys_g) & set(keys_w))
    jac = len(common) / max(1, len(set(keys_g) | set(keys_w)))
    ig = [keys_g.index(c) for c in common]
    iw = [keys_w.index(c) for c in common]
    conf = float(np.abs(vals_g["mconf"][ig] - vals_w["mconf"][iw]).max(
        initial=0.0))
    px = max(float(np.abs(vals_g[n][ig] - vals_w[n][iw]).max(initial=0.0))
             for n in ("mkpts0", "mkpts1"))
    return jac, conf, px


@pytest.mark.parametrize("recipe,overrides", [
    ("outdoor_casmtr_4c", tiny_4c_overrides),
    ("outdoor_casmtr_2c", tiny_2c_overrides)])
def test_bf16_eval_forward_matches_jax(monkeypatch, recipe, overrides):
    """The whole bf16 forward at every stage (1/8, each cascade level, the
    final matches) against the JAX package's bf16 forward.  Thresholds are
    0 and the match capacities above the grids' cell counts, so the sets
    are the mutual-nearest-neighbour sets rather than a top-16 cut through
    confidences that agree to 1e-5.  At this tiny, randomly weighted model
    the dual softmax turns bf16 rounding into large moves: the JAX
    package's own bf16 and float32 forwards differ by more than a fixed
    Jaccard of 0.95 and confidences of 1e-2 allow.  So each stage is held
    to the JAX package's own bf16-against-float32 difference: Jaccard at least
    min(0.95, its Jaccard) - 0.1, common confidences within max(1e-2, 1.5x
    its error) and keypoints within max(5e-2 px, 1.5x its error)."""
    from casmtr_tpu.models.casmtr import CasMTR as JaxCasMTR
    from casmtr_tpu_torch.models.casmtr import CasMTR
    from casmtr_tpu_torch.weights import load_jax_variables
    ov = overrides(zero_thresholds=True)
    n = len(ov["loftr"].get("cascade_levels", [4]))
    ov["loftr"]["match_coarse"]["max_matches"] = 512
    ov["loftr"]["match_cascade"]["max_matches"] = [2048, 8192][:n]
    jcfg, tcfg = configs(ov, recipe)
    img0, img1 = _images(np.random.default_rng(0), 2, 128, 128)
    batch = {"image0": jnp.asarray(img0), "image1": jnp.asarray(img1)}
    jm = JaxCasMTR(jcfg.loftr)
    model = CasMTR(tcfg.loftr)
    variables = port_variables(model, lambda: jm.init(
        jax.random.PRNGKey(0), batch, train=False))
    want = {}
    for env in ("0", "1"):
        for name in ENV:
            monkeypatch.setenv(name, env)
        want[env] = _exact(lambda v, b: jm.apply(v, b, train=False),
                           variables, batch)
    load_jax_variables(model, variables)
    model.eval()
    with torch.inference_mode():   # the environment is still "1"
        got = model({"image0": torch.from_numpy(img0),
                     "image1": torch.from_numpy(img1)})
    assert set(got.cascades) == set(want["1"].cascades)

    def stages(out):
        return ([("1/8", out.coarse.matches)]
                + [(n, out.cascades[n].matches) for n in want["1"].cascades]
                + [("final", out.final_matches)])

    for (stage, g), (_, wb), (_, wf) in zip(stages(got), stages(want["1"]),
                                            stages(want["0"])):
        g, wb, wf = _fields(g), _fields(wb), _fields(wf)
        assert wb["valid"].sum() > 0, stage
        jac, conf, px = _stage_errors(g, wb)
        ref_jac, ref_conf, ref_px = _stage_errors(wf, wb)
        assert jac >= min(MAX_JACCARD, ref_jac) - JACCARD_SLACK, (
            stage, jac, ref_jac)
        assert conf <= max(CONF_ATOL, NOISE_FACTOR * ref_conf), (
            stage, conf, ref_conf)
        assert px <= max(PX_ATOL, NOISE_FACTOR * ref_px), (stage, px, ref_px)
