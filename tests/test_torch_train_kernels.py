"""Gradients of the port's three kernel functions against the JAX package,
on the CPU, in float32 at atol 1e-5 (sums in another order):

* the plain route (autograd through each forward plain version) against
  ``jax.grad`` through the Pallas custom VJPs in interpret mode;
* each backward plain version (the oracle of CUDA kernels A-bwd, B-bwd and
  C-bwd on the card) against torch autograd of its forward plain version,
  with repeated block ids for A and off-grid corners for B's scatter rule;
* each autograd function (``QuadtreeFineAttention``, ``WindowPatchScore``,
  ``WindowCrossAttention``) on CPU tensors, where it takes the two plain
  versions, against the plain route: same output, same gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops.pallas import window_kernels as jwk  # noqa: E402
from casmtr_tpu.ops.pallas.quadtree_kernels import \
    masked_fine_level  # noqa: E402
from casmtr_tpu_torch.ops import kernels  # noqa: E402
from casmtr_tpu_torch.ops.kernels import quadtree_kernels as tqk  # noqa: E402
from casmtr_tpu_torch.ops.kernels import window_kernels as twk  # noqa: E402

ATOL = 1e-5


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _torch_grads(fn, floats, ints, cot):
    """Gradients of sum(fn(*floats, *ints) * cot) w.r.t. the float inputs,
    and the output."""
    xs = [_t(x, True) for x in floats]
    out = fn(*xs, *[_t(i) for i in ints])
    (out * _t(cot)).sum().backward()
    return out.detach(), [x.grad for x in xs]


def _jax_grads(fn, floats, ints, cot):
    args = [jnp.asarray(x) for x in floats]
    rest = [jnp.asarray(i) for i in ints]
    return jax.grad(lambda *a: jnp.sum(fn(*a, *rest) * cot),
                    argnums=tuple(range(len(args))))(*args)


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------

def _fine_case(seed, hw=(8, 12), B=1, H=2, D=8, K=3, distinct=True):
    rng = np.random.default_rng(seed)
    h, w = hw
    P = Lb = (h // 2) * (w // 2)
    q, k, v = (rng.standard_normal((B, h * w, H, D)).astype(np.float32)
               for _ in range(3))
    if distinct:  # the Pallas kernel's precondition
        ids = np.stack([np.stack([np.stack(
            [rng.choice(Lb, size=K, replace=False) for _ in range(H)], -1)
            for _ in range(P)]) for _ in range(B)]).astype(np.int32)
    else:
        ids = rng.integers(0, Lb, (B, P, K, H)).astype(np.int32)
    cot = rng.standard_normal((B, P, 4, H, D)).astype(np.float32)
    return (q, k, v), (ids,), cot, hw


def _score_case(seed, C=12, H1=12, W1=16, w=2, B=1):
    rng = np.random.default_rng(seed)
    P = (H1 // 2) * (W1 // 2)
    q = rng.standard_normal((B, P, 4, C)).astype(np.float32)
    f1 = rng.standard_normal((B, H1, W1, C)).astype(np.float32)
    cy = rng.integers(0, H1 // 2 - w + 1, (B, P))
    cx = rng.integers(0, W1 // 2 - w + 1, (B, P))
    corners = np.stack([cy, cx], -1).astype(np.int32)
    cot = rng.standard_normal((B, P, 4, 4 * w * w)).astype(np.float32)
    return (q, f1), (corners,), cot, w


def _wca_case(seed, H=2, D=8, grid=12, w=2, B=1):
    rng = np.random.default_rng(seed)
    L = grid * grid
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    corners = rng.integers(0, grid // 2 - w + 1,
                           (B, L // 4, 2)).astype(np.int32)
    cot = rng.standard_normal((B, L // 4, 4, H, D)).astype(np.float32)
    return (q, k, v), (corners,), cot, (grid, grid), w


# --------------------------------------------------------------------------
# plain route against jax.grad through the Pallas custom VJPs
# --------------------------------------------------------------------------

def test_quadtree_fine_grads_match_pallas_vjp():
    floats, ints, cot, hw = _fine_case(0)
    _, got = _torch_grads(
        lambda q, k, v, i: tqk.quadtree_fine_attention_plain(q, k, v, i, hw,
                                                             hw),
        floats, ints, cot)
    want = _jax_grads(
        lambda q, k, v, i: masked_fine_level(q, k, v, i, hw, hw, topk=0,
                                             interpret=True)[0],
        floats, ints, cot)
    for g, w in zip(got, want):
        _close(g, w)


def test_window_patch_score_grads_match_pallas_vjp():
    floats, ints, cot, w = _score_case(1)
    _, got = _torch_grads(
        lambda q, f1, c: twk.window_patch_score_plain(q, f1, c, w),
        floats, ints, cot)
    want = _jax_grads(
        lambda q, f1, c: jwk.window_patch_score_pallas(q, f1, c, w, True),
        floats, ints, cot)
    for g, wt in zip(got, want):
        _close(g, wt)


def test_window_cross_attention_grads_match_pallas_vjp():
    floats, ints, cot, hw, w = _wca_case(2)
    _, got = _torch_grads(
        lambda q, k, v, c: twk.window_cross_attention_plain(q, k, v, c, hw,
                                                            hw, w),
        floats, ints, cot)
    want = _jax_grads(
        lambda q, k, v, c: jwk.window_cross_attention(q, k, v, c, hw, hw, w,
                                                      True),
        floats, ints, cot)
    for g, wt in zip(got, want):
        _close(g, wt)


# --------------------------------------------------------------------------
# backward plain versions against autograd of the forward plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("distinct", [True, False], ids=["distinct",
                                                         "repeated"])
def test_quadtree_fine_bwd_plain_matches_autograd(distinct):
    floats, ints, cot, hw = _fine_case(3, distinct=distinct)
    if not distinct:  # the case the Pallas kernel excludes
        ids = ints[0]
        assert any(len(set(ids[0, p, :, h])) < ids.shape[2]
                   for p in range(ids.shape[1]) for h in range(2))
    out, want = _torch_grads(
        lambda q, k, v, i: tqk.quadtree_fine_attention_plain(q, k, v, i, hw,
                                                             hw),
        floats, ints, cot)
    q, k, v = (_t(x) for x in floats)
    msg, lse = tqk.quadtree_fine_attention_plain(q, k, v, _t(ints[0]), hw, hw,
                                                 with_lse=True)
    _close(msg, out, 0)
    got = tqk.quadtree_fine_attention_bwd_plain(q, k, v, _t(ints[0]), msg,
                                                lse, _t(cot), hw, hw)
    for g, w in zip(got, want):
        _close(g, w)


def test_window_patch_score_bwd_plain_matches_autograd():
    floats, ints, cot, w = _score_case(4)
    _, want = _torch_grads(
        lambda q, f1, c: twk.window_patch_score_plain(q, f1, c, w),
        floats, ints, cot)
    got = twk.window_patch_score_bwd_plain(*(_t(x) for x in floats),
                                           _t(ints[0]), _t(cot), w)
    for g, wt in zip(got, want):
        _close(g, wt)


def test_window_patch_score_bwd_plain_follows_jax_scatter_rule():
    """Corners whose patch runs off the grid: dq takes the clipped gather,
    dfeat1 the JAX scatter rule (a negative flat index wraps once, one still
    outside the grid is dropped), as the custom VJP's ``_bwd`` does."""
    (q, f1), (corners,), cot, w = _score_case(5)
    corners[0, :6] = [[-2, 0], [0, 7], [5, 7], [4, 6], [5, -1], [-1, -1]]
    got = twk.window_patch_score_bwd_plain(_t(q), _t(f1), _t(corners),
                                           _t(cot), w)
    want = jwk._bwd(w, True, (jnp.asarray(q), jnp.asarray(f1),
                              jnp.asarray(corners)), jnp.asarray(cot))
    for g, wt in zip(got, want[:2]):
        _close(g, wt)
    idx = torch.tensor([-1, -7, 5, 7, -5, -6])
    assert twk.scatter_index(idx, 5).tolist() == [4, -1, -1, -1, 0, -1]


def test_window_cross_attention_bwd_plain_matches_autograd():
    floats, ints, cot, hw, w = _wca_case(6, H=3, D=5)
    out, want = _torch_grads(
        lambda q, k, v, c: twk.window_cross_attention_plain(q, k, v, c, hw,
                                                            hw, w),
        floats, ints, cot)
    q, k, v = (_t(x) for x in floats)
    msg, lse = twk.window_cross_attention_plain(q, k, v, _t(ints[0]), hw, hw,
                                                w, with_lse=True)
    _close(msg, out, 0)
    got = twk.window_cross_attention_bwd_plain(q, k, v, _t(ints[0]), msg, lse,
                                               _t(cot), hw, hw, w)
    for g, wt in zip(got, want):
        _close(g, wt)


# --------------------------------------------------------------------------
# the autograd functions on CPU tensors against the plain route
# --------------------------------------------------------------------------

def _function_vs_plain(function_call, plain_call, floats, ints, cot):
    kernels.reset_launch_counts()
    out_f, got = _torch_grads(function_call, floats, ints, cot)
    out_p, want = _torch_grads(plain_call, floats, ints, cot)
    _close(out_f, out_p)
    for g, w in zip(got, want):
        _close(g, w)
    assert not any(kernels.LAUNCHES.values())  # CPU: no kernel launched


def test_quadtree_function_on_cpu_matches_plain_route():
    floats, ints, cot, hw = _fine_case(7, distinct=False)
    _function_vs_plain(
        lambda q, k, v, i: tqk.QuadtreeFineAttention.apply(q, k, v, i, hw, hw,
                                                           True),
        lambda q, k, v, i: tqk.quadtree_fine_attention(q, k, v, i, hw, hw),
        floats, ints, cot)


def test_window_score_function_on_cpu_matches_plain_route():
    floats, ints, cot, w = _score_case(8)
    _function_vs_plain(
        lambda q, f1, c: twk.WindowPatchScore.apply(q, f1, c, w),
        lambda q, f1, c: twk.window_patch_score(q, f1, c, w),
        floats, ints, cot)


def test_window_attention_function_on_cpu_matches_plain_route():
    floats, ints, cot, hw, w = _wca_case(9)
    _function_vs_plain(
        lambda q, k, v, c: twk.WindowCrossAttention.apply(q, k, v, c, hw, hw,
                                                          w, True),
        lambda q, k, v, c: twk.window_cross_attention(q, k, v, c, hw, hw, w),
        floats, ints, cot)
