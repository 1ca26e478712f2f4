"""Kernel A′ of the port, the quadtree fine level with its top-k selection
fused in, against the JAX package on the CPU.  On the CPU the wrapper takes
``quadtree_fine_topk_plain`` (a CUDA kernel has no interpret mode), so these
tests pin the arithmetic the kernel is held to on the card:

* against ``masked_fine_level(..., topk=k)`` (the TPU kernel A′, Pallas in
  interpret mode) and against the gather path ``_fine_level_b(...,
  need_topk=True)``, at three geometries (square, non-square, and P > 128
  parents, the Pallas kernel's padding path): messages within 1e-5, the
  sorted top-k scores within 1e-6, and the selected indices compared
  through the next level's message, which does not depend on the order of
  near-tied indices (within 1e-5);
* repeated block ids (the port has no distinct-ids precondition) against
  the gather path;
* the wrapper and the autograd function ``QuadtreeFineAttention`` with
  ``topk`` on CPU tensors take the plain version, launch nothing, carry the
  message's gradient and none through the selection."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops import quadtree as jqt  # noqa: E402
from casmtr_tpu.ops.pallas.quadtree_kernels import \
    masked_fine_level  # noqa: E402
from casmtr_tpu_torch.ops import kernels  # noqa: E402
from casmtr_tpu_torch.ops.kernels import quadtree_kernels as tqk  # noqa: E402

ATOL = 1e-5        # f32 sums in another order (XLA-CPU vs ATen)
SCORE_ATOL = 1e-6  # probabilities in [0, 1]


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _case(seed, B, H, D, hw, K, distinct=True):
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
    return q, k, v, ids


def _next_level_message(sel, hw, seed):
    """The message of the next (2x finer) level that reads ``sel``
    [B, Lq, k, H] as its block ids, from fixed random q/k/v: it depends on
    the selected set of each row, not on the order within it."""
    sel = np.asarray(sel).astype(np.int32)
    B, _, _, H = sel.shape
    hw_n = (2 * hw[0], 2 * hw[1])
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, hw_n[0] * hw_n[1], H, 8))
               .astype(np.float32) for _ in range(3))
    return tqk.quadtree_fine_attention_plain(_t(q), _t(k), _t(v), _t(sel),
                                             hw_n, hw_n)


GEOMETRIES = {
    "square": (2, 3, 8, (8, 8), 3, 5),
    "non_square": (1, 2, 16, (12, 20), 4, 7),
    # P = 168 parents: the Pallas kernel pads them to two 128-parent tiles
    "padded_parents": (1, 2, 8, (24, 28), 4, 16),
}


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_fused_topk_plain_matches_pallas_and_gather_path(name):
    B, H, D, hw, K, topk = GEOMETRIES[name]
    q, k, v, ids = _case(0, B, H, D, hw, K)
    msg, score, idx = tqk.quadtree_fine_topk_plain(_t(q), _t(k), _t(v),
                                                   _t(ids), hw, hw, topk)
    assert msg.shape == (B, hw[0] * hw[1] // 4, 4, H, D)
    assert score.shape == idx.shape == (B, hw[0] * hw[1], topk, H)
    assert idx.dtype == torch.int32
    j = [jnp.asarray(x) for x in (q, k, v, ids)]
    p_msg, p_score, p_idx = masked_fine_level(*j, hw, hw, topk=topk,
                                              interpret=True)
    _, g_msg, g_score, g_idx = jqt._fine_level_b(*j, topk, hw, hw,
                                                 hw[1] // 2, need_topk=True)
    nxt = _next_level_message(idx, hw, 1)
    for want_msg, want_score, want_idx in ((p_msg, p_score, p_idx),
                                           (g_msg, g_score, g_idx)):
        _close(msg, want_msg)
        _close(np.sort(score.numpy(), axis=2),
               np.sort(np.asarray(want_score), axis=2), SCORE_ATOL)
        _close(nxt, _next_level_message(want_idx, hw, 1))
    # descending per row, and the scores are the selected probabilities
    assert (np.diff(score.numpy(), axis=2) <= 0).all()
    assert (score.numpy() > 0).all() and (score.sum(2) <= 1 + 1e-6).all()


def test_fused_topk_plain_with_duplicate_ids_matches_gather_path():
    """Repeated block ids count once per occurrence, as in the gather
    oracle: a repeated candidate may be selected twice."""
    hw, K, topk = (8, 12), 5, 6
    q, k, v, ids = _case(2, 1, 2, 8, hw, K, distinct=False)
    assert any(len(set(ids[0, p, :, h])) < K
               for p in range(ids.shape[1]) for h in range(2))
    msg, score, idx = tqk.quadtree_fine_topk_plain(_t(q), _t(k), _t(v),
                                                   _t(ids), hw, hw, topk)
    _, g_msg, g_score, g_idx = jqt._fine_level_b(
        *(jnp.asarray(x) for x in (q, k, v, ids)), topk, hw, hw, hw[1] // 2,
        need_topk=True)
    _close(msg, g_msg)
    _close(np.sort(score.numpy(), axis=2), np.sort(np.asarray(g_score),
                                                   axis=2), SCORE_ATOL)
    _close(_next_level_message(idx, hw, 3),
           _next_level_message(g_idx, hw, 3))


def test_fused_topk_lse_is_the_rows_logsumexp():
    hw, K, topk = (8, 8), 3, 4
    q, k, v, ids = _case(4, 1, 2, 8, hw, K)
    args = (_t(q), _t(k), _t(v), _t(ids), hw, hw)
    msg, score, idx, lse = tqk.quadtree_fine_topk_plain(*args, topk,
                                                        with_lse=True)
    want_msg, want_lse = tqk.quadtree_fine_attention_plain(*args,
                                                           with_lse=True)
    assert torch.equal(msg, want_msg)
    _close(lse, want_lse, 1e-6)


def test_fused_topk_wrapper_takes_plain_on_cpu():
    hw, K, topk = (8, 12), 4, 5
    q, k, v, ids = _case(5, 1, 2, 8, hw, K)
    kernels.reset_launch_counts()
    args = (_t(q), _t(k), _t(v), _t(ids), hw, hw, topk)
    got = tqk.quadtree_fine_topk(*args)
    want = tqk.quadtree_fine_topk_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not any(kernels.LAUNCHES.values())  # CPU: no kernel launched


@pytest.mark.parametrize("route", ["wrapper", "function"])
def test_fused_topk_gradient_is_the_message_gradient(route):
    """On CPU tensors the wrapper (plain route) and ``QuadtreeFineAttention``
    with ``topk`` (the two plain versions behind the autograd function) give
    the gradient of the message alone, that of ``quadtree_fine_attention``;
    the score and index outputs carry no gradient."""
    hw, K, topk = (8, 12), 3, 4
    q, k, v, ids = _case(6, 1, 2, 8, hw, K, distinct=False)
    cot = np.random.default_rng(7).standard_normal(
        (1, 24, 4, 2, 8)).astype(np.float32)

    def grads(call):
        xs = [_t(x, True) for x in (q, k, v)]
        outs = call(*xs, _t(ids))
        msg = outs[0] if isinstance(outs, tuple) else outs
        (msg * _t(cot)).sum().backward()
        return outs, [x.grad for x in xs]

    kernels.reset_launch_counts()
    if route == "wrapper":
        outs, got = grads(lambda q_, k_, v_, i: tqk.quadtree_fine_topk(
            q_, k_, v_, i, hw, hw, topk))
    else:
        outs, got = grads(lambda q_, k_, v_, i:
                          tqk.QuadtreeFineAttention.apply(
                              q_, k_, v_, i, hw, hw, True, topk))
    _, want = grads(lambda q_, k_, v_, i: tqk.quadtree_fine_attention(
        q_, k_, v_, i, hw, hw))
    assert not outs[1].requires_grad and not outs[2].requires_grad
    for g, w in zip(got, want):
        _close(g, w)
    assert not any(kernels.LAUNCHES.values())
