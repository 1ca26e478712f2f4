"""The port's bf16 training step against the JAX package's, on the CPU.

* Kernels A-bwd and C-bwd on bf16 q/k/v: the plain backward (autograd of
  the plain forward, which widens the bf16 values to float32) against
  ``jax.vjp`` of the Pallas kernels in interpret mode (``masked_fine_level``
  for A and A′, ``window_cross_attention`` for C).  On the same widened
  values in float32 both packages compute the same function: within 1e-5
  of the largest gradient.  On bf16 inputs the Pallas kernels also round
  the cotangent, dS and the probabilities to bf16 and return bf16
  gradients, while the port's f32 arithmetic rounds only its gradients:
  the two are held within 2e-2 of the largest gradient (a bound fixed
  before the first run; the measured gap is printed).  The backward plain
  versions (the CUDA kernels' oracle on the card) take bf16 inputs and give
  the float32 gradients of autograd; the autograd functions on the CPU
  return them rounded to the inputs' dtype.
* The policy: ``backbone_dtype``, ``transformer_dtype`` and ``table_dtype``
  for every device, mode and value of ``CASMTR_BACKBONE_BF16`` and
  ``CASMTR_TRANSFORMER_BF16``, on ``torch.device`` objects (no card).
* The Twins FPN in train mode with ``CASMTR_BACKBONE_BF16=1``: its maps
  and running statistics nearer to the JAX package's bf16 ones than to its
  float32 ones, and gradients through ``precision.run`` on every parameter.
* One tiny-4c training step with ``CASMTR_BACKBONE_BF16=1`` (bf16
  backbone; float32 stacks and kernel inputs on the CPU, as the JAX
  package's CPU graph) against the JAX package's step under the same
  variable, the JAX side compiled with XLA's excess precision off (as in
  test_torch_bf16.py).  The two packages round at other points (the port's
  GELU and resize round once, flax's per operation), so each bf16 step is
  an independent sample of the rounding noise.  The loss terms, the
  per-leaf gradients and the BatchNorm statistics are each held within 2x
  the JAX package's own bf16-against-float32 difference (or the float32
  tolerances of test_torch_train.py where larger), with the float32 steps
  within those tolerances of each other.  The fine loss alone is printed,
  not gated: the tiny random model amplifies the rounding in its fine
  stage, where the two packages' own bf16-against-float32 fine losses part
  several-fold.
* The limits of the bf16 backward instances raise before any CUDA call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops.pallas.quadtree_kernels import \
    masked_fine_level  # noqa: E402
from casmtr_tpu.ops.pallas.window_kernels import \
    window_cross_attention as jax_wca  # noqa: E402
from casmtr_tpu_torch.ops import kernels  # noqa: E402
from casmtr_tpu_torch.ops.kernels import quadtree_kernels as tqk  # noqa
from casmtr_tpu_torch.ops.kernels import window_kernels as twk  # noqa: E402
from tests.test_torch_train import _leaves as leaves  # noqa: E402
from tests.test_torch_train import (_pair_batch, jax_step,  # noqa: E402
                                    step_variables, torch_step)
from tests.torch_parity import configs, tiny_4c_overrides  # noqa: E402

ENV = ("CASMTR_BACKBONE_BF16", "CASMTR_TRANSFORMER_BF16")
F32_GRAD_RTOL = 1e-5       # of the largest gradient: float32 sums
PALLAS_BF16_GRAD_RTOL = 2e-2   # of the largest gradient: the Pallas bf16
                               # kernels round g, dS and p to bf16
BF16_ULP = 2.0 ** -8       # a gradient rounded to bf16, of its largest value
# the bf16 step: within NOISE_FACTOR x the JAX package's own
# bf16-against-float32 difference (the port's bf16 rounding is a second,
# independent sample of that noise), or the float32 tolerance where larger
NOISE_FACTOR = 2.0
# the terms left out of that gate: the tiny model's fine loss, whose two
# packages' own bf16-against-float32 differences part several-fold
UNGATED_TERMS = ("loss_f",)
STEP_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BN_ATOL = 1e-5
TRAIN_SIZE = 64


def _bf16(x):
    """The same numpy array rounded to bf16 by both packages."""
    return (torch.from_numpy(np.asarray(x)).bfloat16(),
            jnp.asarray(x, jnp.bfloat16))


def _rel_err(got, want):
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# kernels A-bwd and C-bwd on bf16 q/k/v
# --------------------------------------------------------------------------

def _fine_case(seed, B, H, D, hw, K):
    """Unit-normal q/k/v, distinct block ids (the Pallas kernel's
    precondition) and a cotangent of the message."""
    rng = np.random.default_rng(seed)
    L, Lb = hw[0] * hw[1], (hw[0] // 2) * (hw[1] // 2)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    ids = np.stack([np.stack([np.stack(
        [rng.choice(Lb, size=K, replace=False) for _ in range(H)], -1)
        for _ in range(Lb)]) for _ in range(B)]).astype(np.int32)
    cot = rng.standard_normal((B, Lb, 4, H, D)).astype(np.float32)
    return (q, k, v), ids, cot


def _wca_case(seed, H, D, grid, w):
    rng = np.random.default_rng(seed)
    L = grid * grid
    q, k, v = (rng.standard_normal((1, L, H, D)).astype(np.float32)
               for _ in range(3))
    corners = rng.integers(0, grid // 2 - w + 1, (1, L // 4, 2)
                           ).astype(np.int32)
    cot = rng.standard_normal((1, L // 4, 4, H, D)).astype(np.float32)
    return (q, k, v), corners, cot


def _torch_grads(fn, qkv_bf16, cot, widened):
    """Gradients of sum(fn(q, k, v) * cot) through the plain forward on
    bf16 q/k/v: with ``widened`` against the float32 values it widens them
    to (the CUDA kernels' float32 outputs), else against the bf16 leaves
    (rounded to bf16 by the widening's backward)."""
    xs = [(t.float() if widened else t).requires_grad_(True)
          for t in qkv_bf16]
    (fn(*xs) * torch.from_numpy(cot)).sum().backward()
    return [x.grad for x in xs]


def _jax_grads(fn, qkv, cot):
    """``jax.vjp`` of ``fn`` at ``qkv`` on ``cot``, compiled once (an
    interpret-mode Pallas kernel runs its grid loop inside the graph
    rather than op by op) with XLA's excess precision off, so the bf16
    roundings stay where the kernel puts them."""
    def grads(*xs):
        return jax.vjp(fn, *xs)[1](jnp.asarray(cot))

    return jax.jit(grads).lower(*qkv).compile(
        {"xla_allow_excess_precision": False})(*qkv)


def _hold_bwd(label, torch_fn, jax_fn, qkv, cot):
    pairs = [_bf16(x) for x in qkv]
    tq, jq = [p[0] for p in pairs], [p[1] for p in pairs]
    want_f32 = _jax_grads(jax_fn, [x.astype(jnp.float32) for x in jq], cot)
    got_f32 = _torch_grads(torch_fn, tq, cot, widened=True)
    want_bf16 = _jax_grads(jax_fn, jq, cot)
    got_bf16 = _torch_grads(torch_fn, tq, cot, widened=False)
    gaps = []
    for name, g32, w32, g16, w16 in zip("qkv", got_f32, want_f32, got_bf16,
                                        want_bf16):
        assert g32.dtype == torch.float32 and g16.dtype == torch.bfloat16
        assert w16.dtype == jnp.bfloat16
        assert _rel_err(g32, w32) <= F32_GRAD_RTOL, (label, name)
        gaps.append(_rel_err(g16.float(), w16))
    print(f"{label}: port bf16 gradients against the Pallas bf16 kernel's, "
          f"of the largest gradient: dq {gaps[0]:.3e} dk {gaps[1]:.3e} dv "
          f"{gaps[2]:.3e} (bound {PALLAS_BF16_GRAD_RTOL:g})")
    assert max(gaps) <= PALLAS_BF16_GRAD_RTOL, (label, gaps)


@pytest.mark.parametrize("B,H,D,hw,K,topk", [
    (2, 2, 16, (8, 8), 3, 0),       # kernel A's gradient
    (1, 2, 8, (8, 8), 3, 4),        # kernel A′'s message gradient
])
def test_quadtree_bwd_on_bf16_matches_pallas(B, H, D, hw, K, topk):
    qkv, ids, cot = _fine_case(B + H + K, B, H, D, hw, K)
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)

    def torch_fn(q, k, v):
        if topk:
            return tqk.quadtree_fine_topk_plain(q, k, v, tids, hw, hw,
                                                topk)[0]
        return tqk.quadtree_fine_attention_plain(q, k, v, tids, hw, hw)

    def jax_fn(q, k, v):
        return masked_fine_level(q, k, v, jids, hw, hw, topk=topk,
                                 interpret=True)[0]

    _hold_bwd(f"A-bwd (topk {topk})", torch_fn, jax_fn, qkv, cot)


@pytest.mark.parametrize("H,D,grid,w", [(4, 16, 8, 2), (2, 8, 8, 1)])
def test_window_bwd_on_bf16_matches_pallas(H, D, grid, w):
    qkv, corners, cot = _wca_case(H * D, H, D, grid, w)
    hw = (grid, grid)
    tc, jc = torch.from_numpy(corners), jnp.asarray(corners)
    _hold_bwd(
        "C-bwd",
        lambda q, k, v: twk.window_cross_attention_plain(q, k, v, tc, hw, hw,
                                                         w),
        lambda q, k, v: jax_wca(q, k, v, jc, hw, hw, w, True), qkv, cot)


@pytest.mark.parametrize("kind", ["quadtree", "window"])
def test_bwd_plain_and_function_on_bf16(kind):
    """The backward plain version on bf16 q/k/v (the CUDA kernel's oracle)
    gives autograd's float32 gradients of the plain forward on the widened
    values; the autograd function on CPU tensors returns them rounded to
    bf16."""
    if kind == "quadtree":
        qkv, ids, cot = _fine_case(5, 1, 2, 8, (8, 12), 3)
        hw, extra, w = (8, 12), torch.from_numpy(ids), None
        plain, bwd = (tqk.quadtree_fine_attention_plain,
                      tqk.quadtree_fine_attention_bwd_plain)

        def function(q, k, v):
            return tqk.QuadtreeFineAttention.apply(q, k, v, extra, hw, hw,
                                                   True, 0)
    else:
        qkv, corners, cot = _wca_case(6, 2, 8, 12, 2)
        hw, extra, w = (12, 12), torch.from_numpy(corners), 2
        plain = (lambda q, k, v, c, a, b, with_lse=False:
                 twk.window_cross_attention_plain(q, k, v, c, a, b, w,
                                                  with_lse))
        bwd = (lambda *args: twk.window_cross_attention_bwd_plain(*args, w))

        def function(q, k, v):
            return twk.WindowCrossAttention.apply(q, k, v, extra, hw, hw, w,
                                                  True)
    tq = [_bf16(x)[0] for x in qkv]
    g = torch.from_numpy(cot)
    want = _torch_grads(lambda q, k, v: plain(q, k, v, extra, hw, hw), tq,
                        cot, widened=True)
    out, lse = plain(*tq, extra, hw, hw, with_lse=True)
    got = bwd(*tq, extra, out.contiguous(), lse.contiguous(), g, hw, hw)
    xs = [t.clone().requires_grad_(True) for t in tq]
    (function(*xs) * g).sum().backward()
    for a, b, x in zip(got, want, xs):
        assert a.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
        assert _rel_err(a, b) <= F32_GRAD_RTOL
        assert _rel_err(x.grad.float(), b) <= BF16_ULP + F32_GRAD_RTOL


# --------------------------------------------------------------------------
# the policy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backbone_env", [None, "0", "1"])
@pytest.mark.parametrize("transformer_env", [None, "0", "1"])
def test_policy_per_device_mode_and_variables(monkeypatch, backbone_env,
                                              transformer_env):
    """Backbone: bf16 on the card in both modes, float32 on the CPU;
    stacks: bf16 on the card in eval only; tables: bf16 on the card in both
    modes, float32 on the CPU.  A variable at 0 or 1 forces its stack's
    dtype; the stacks' variable at 0 also keeps the card's tables float32,
    so both at 0 make the card's graph all float32."""
    from casmtr_tpu_torch.models.backbone.resnet_fpn import backbone_dtype
    from casmtr_tpu_torch.models.transformer import (table_dtype,
                                                     transformer_dtype)
    bf16, f32 = torch.bfloat16, torch.float32
    for name, value in zip(ENV, (backbone_env, transformer_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    forced = {None: None, "0": f32, "1": bf16}
    for dev in (torch.device("cuda"), torch.device("cuda", 0),
                torch.device("cpu")):
        card = dev.type == "cuda"
        for train in (False, True):
            want = (forced[backbone_env] or (bf16 if card else f32),
                    forced[transformer_env]
                    or (bf16 if card and not train else f32),
                    bf16 if card and transformer_env != "0" else f32)
            got = (backbone_dtype(dev, train), transformer_dtype(dev, train),
                   table_dtype(dev))
            assert got == want, (dev, train, got, want)
            if card and backbone_env == transformer_env == "0":
                assert got == (f32, f32, f32)


# --------------------------------------------------------------------------
# one tiny-4c training step with a bf16 backbone
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_step():
    """Each package's step in float32 and with CASMTR_BACKBONE_BF16=1 (the
    JAX side compiled with excess precision off), from the same jittered
    variables and batch: {"jax f32" | "jax bf16" | "port f32" | "port
    bf16": (scalars, gradients, batch statistics)}."""
    ov = tiny_4c_overrides(train_size=TRAIN_SIZE)
    ov["loftr"]["match_cascade"]["double_check"] = [False]
    jcfg, tcfg = configs(ov)
    batch = _pair_batch(size=TRAIN_SIZE)
    jm, like, variables = step_variables(jcfg, tcfg, batch)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ENV:
            mp.delenv(name, raising=False)
        for prec in ("f32", "bf16"):
            if prec == "bf16":
                mp.setenv("CASMTR_BACKBONE_BF16", "1")
            runs["jax " + prec] = jax_step(jm, jcfg, variables, batch,
                                           exact=True)
            runs["port " + prec] = torch_step(tcfg, variables, like, batch)
    return runs


def _envelope(bf16_step, part, norm):
    """Per entry of ``part`` (0 scalars, 1 gradients, 2 statistics): the
    error of the port's bf16 step against the JAX package's, the noise
    envelope NOISE_FACTOR x the JAX package's own bf16-against-float32
    difference, and the port's float32 error, each by ``norm``."""
    jf, jb, tf, tb = (leaves(bf16_step[k][part]) for k in (
        "jax f32", "jax bf16", "port f32", "port bf16"))
    assert tb.keys() == jb.keys() == tf.keys()
    return {k: (norm(tb[k] - jb[k]), NOISE_FACTOR * norm(jf[k] - jb[k]),
                norm(tf[k] - jf[k])) for k in jb}


def test_bf16_train_step_loss_matches_jax(bf16_step):
    js = bf16_step["jax bf16"][0]
    terms = _envelope(bf16_step, 0, lambda x: float(np.abs(x)))
    for k in ("loss", "loss_8c", "loss_4c", "loss_f", "grad_norm"):
        err, noise, f32_err = terms[f"['{k}']"]
        scale = abs(float(js[k]))
        print(f"{k}: bf16 error {err / scale:.3e} relative, envelope "
              f"{noise / scale:.3e}, float32 error {f32_err / scale:.3e}"
              + (" (not gated)" if k in UNGATED_TERMS else ""))
        assert f32_err <= STEP_LOSS_RTOL * scale, k
        assert k in UNGATED_TERMS or err <= max(STEP_LOSS_RTOL * scale,
                                                noise), k
    # the bf16 backbone is in effect
    assert float(bf16_step["port bf16"][0]["loss"]) != float(
        bf16_step["port f32"][0]["loss"])
    assert int(bf16_step["port bf16"][0]["valid_n_4c"]) > 0


def test_bf16_train_step_gradients_match_jax(bf16_step):
    want = leaves(bf16_step["jax bf16"][1])
    total = float(np.sqrt(sum(float((w ** 2).sum()) for w in want.values())))
    worst = 0.0
    for k, (err, noise, f32_err) in _envelope(bf16_step, 1,
                                              np.linalg.norm).items():
        assert np.isfinite(leaves(bf16_step["port bf16"][1])[k]).all(), k
        scale = max(float(np.linalg.norm(want[k])), 1e-3 * total)
        assert f32_err <= GRAD_RTOL * scale, k
        bound = max(GRAD_RTOL * scale, noise)
        worst = max(worst, err / bound)
        assert err <= bound, (k, err / scale, noise / scale)
    print(f"largest gradient error over its bound: {worst:.3f}")


def test_bf16_train_step_batch_stats_match_jax(bf16_step):
    for k, (err, noise, f32_err) in _envelope(
            bf16_step, 2, lambda x: float(np.abs(x).max())).items():
        assert f32_err <= BN_ATOL, k
        assert err <= max(BN_ATOL, noise), (k, err, noise)


def test_twins_fpn_bf16_train_mode_matches_jax(monkeypatch):
    """The Twins FPN in train mode with CASMTR_BACKBONE_BF16=1 (every step
    in bf16, BatchNorm on its batch statistics from the widened bf16
    activations) against the JAX package's in both precisions: the maps
    within 2e-2 of the largest value of JAX's bf16 maps and nearer to them
    than to JAX's float32 maps (RMS), the running statistics after the
    forward nearer to JAX's bf16 ones; and a gradient through
    ``precision.run`` reaches every parameter in float32."""
    from casmtr_tpu.models.backbone.twins import TwinsFPN_8_4_2 as JaxTwins
    from casmtr_tpu_torch.models.backbone.twins import TwinsFPN_8_4_2
    from casmtr_tpu_torch.weights import jax_variables, load_jax_variables
    from tests.torch_parity import jitter
    x = np.random.default_rng(4).random((2, 64, 96, 3)).astype(np.float32)
    jm = JaxTwins(initial_dim=8, block_dims=(8, 12, 16), model_type="small")
    variables = jitter(jax.jit(jm.init)(jax.random.PRNGKey(4),
                                        jnp.asarray(x)), seed=4)

    want = {}
    for prec, env in (("f32", "0"), ("bf16", "1")):
        monkeypatch.setenv("CASMTR_BACKBONE_BF16", env)

        def apply(v, x):   # a new function: jit traces it anew
            return jm.apply(v, x, train=True, mutable=["batch_stats"])

        want[prec] = jax.jit(apply).lower(variables, jnp.asarray(x)).compile(
            {"xla_allow_excess_precision": False})(variables, jnp.asarray(x))
    tm = TwinsFPN_8_4_2(8, (8, 12, 16), "small")
    load_jax_variables(tm, variables)
    tm.train()
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))   # env still "1"
    for g, wb, wf in zip(got, want["bf16"][0], want["f32"][0]):
        assert g.dtype == torch.float32
        g = g.detach().permute(0, 2, 3, 1).numpy()
        wb, wf = np.asarray(wb, np.float32), np.asarray(wf, np.float32)
        assert np.abs(g - wb).max() <= 2e-2 * np.abs(wb).max()
        assert np.sqrt(np.mean((g - wb) ** 2)) < np.sqrt(np.mean(
            (g - wf) ** 2))
    stats = leaves(jax_variables(tm.state_dict(), {
        "batch_stats": want["bf16"][1]["batch_stats"]}))
    sb, sf = (leaves({"batch_stats": want[p][1]["batch_stats"]})
              for p in ("bf16", "f32"))
    near = sum(np.abs(stats[k] - sb[k]).sum() for k in sb)
    far = sum(np.abs(stats[k] - sf[k]).sum() for k in sb)
    assert near < far, (near, far)
    sum((t * t).sum() for t in got).backward()
    for n, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n


# --------------------------------------------------------------------------
# the limits of the bf16 backward instances
# --------------------------------------------------------------------------

def test_bf16_bwd_limits_raise_before_any_cuda_call():
    """The backward wrappers' argument checks that need no card: odd widths
    and misaligned bf16 q/k/v raise ValueError; valid bf16 inputs pass them
    and stop only at the device check.  Their launches are counted apart."""
    hw = (8, 8)
    ids = torch.zeros((1, 16, 2, 2), dtype=torch.int32)
    corners = torch.zeros((1, 16, 2), dtype=torch.int32)

    def qkv(D, H=2, offset=0):
        n = 64 * H * D
        t = torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(
            1, 64, H, D)
        return t, t.clone(), t.clone()

    def quadtree(q, k, v):
        H, D = q.shape[2:]
        out = torch.zeros((1, 16, 4, H, D))
        tqk._launch_bwd(q, k, v, ids, out, out[..., 0], out, hw, hw)

    def window(q, k, v):
        H, D = q.shape[2:]
        out = torch.zeros((1, 16, 4, H, D))
        twk._launch_wca_bwd(q, k, v, corners, out, out[..., 0], out, hw, hw,
                            2)

    before = dict(kernels.LAUNCHES)
    for check in (quadtree, window):
        with pytest.raises(ValueError, match="4-byte aligned"):
            check(*qkv(8, offset=1))
        for ok in (qkv(8), qkv(6, offset=2)):
            with pytest.raises(ValueError, match="CUDA"):
                check(*ok)
    with pytest.raises(ValueError, match="even head width"):
        quadtree(*qkv(5))
    with pytest.raises(ValueError, match="even row width"):
        window(*qkv(5, H=1))
    assert kernels.LAUNCHES == before
    for name in ("quadtree_fine_attention_bwd", "window_cross_attention_bwd"):
        assert before[name + "_bf16"] == 0
        assert f"casmtr_{name}_bf16" in kernels._SIGNATURES
