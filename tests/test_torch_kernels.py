"""Plain PyTorch versions of the port's three CUDA kernels against the JAX
package: each against the Pallas kernel in interpret mode and against its
jnp oracle, in float32 at atol 1e-5.  On the CPU the kernel wrappers take
the plain version (a CUDA kernel has no interpret mode), so these tests pin
the arithmetic the kernels are held to on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.models.cascade_transformer import \
    window_warp_idx as jax_window_warp_idx  # noqa: E402
from casmtr_tpu.ops import gather_ops  # noqa: E402
from casmtr_tpu.ops import quadtree as jqt  # noqa: E402
from casmtr_tpu.ops.pallas.quadtree_kernels import \
    masked_fine_level  # noqa: E402
from casmtr_tpu.ops.pallas.window_kernels import (  # noqa: E402
    window_cross_attention as jax_wca, window_cross_attention_oracle,
    window_patch_score_jnp, window_patch_score_pallas)
from casmtr_tpu.ops.propagation import \
    get_propagations as jax_propagations  # noqa: E402
from casmtr_tpu_torch.ops import kernels  # noqa: E402
from casmtr_tpu_torch.ops import quadtree as tqt  # noqa: E402
from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (  # noqa: E402
    quadtree_fine_attention, quadtree_fine_attention_plain)
from casmtr_tpu_torch.ops.kernels.window_kernels import (  # noqa: E402
    window_cross_attention, window_cross_attention_plain, window_patch_score,
    window_patch_score_plain)

ATOL = 1e-5  # f32 sums in another order (XLA-CPU vs ATen)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# --------------------------------------------------------------------------
# Kernel A: quadtree fine-level attention
# --------------------------------------------------------------------------

def _fine_case(seed, B, H, D, hw_q, hw_k, K, distinct=True):
    rng = np.random.default_rng(seed)
    (h0, w0), (h1, w1) = hw_q, hw_k
    P, Lb = (h0 // 2) * (w0 // 2), (h1 // 2) * (w1 // 2)
    q = rng.standard_normal((B, h0 * w0, H, D)).astype(np.float32)
    k = rng.standard_normal((B, h1 * w1, H, D)).astype(np.float32)
    v = rng.standard_normal((B, h1 * w1, H, D)).astype(np.float32)
    if distinct:  # the Pallas kernel's precondition
        ids = np.stack([np.stack([np.stack(
            [rng.choice(Lb, size=K, replace=False) for _ in range(H)], -1)
            for _ in range(P)]) for _ in range(B)]).astype(np.int32)
    else:
        ids = rng.integers(0, Lb, (B, P, K, H)).astype(np.int32)
    return q, k, v, ids


def _jax_fine_oracle(q, k, v, ids, hw_q, hw_k):
    """The gather path of casmtr_tpu's _fine_level_b (message only)."""
    _, msg, _, _ = jqt._fine_level_b(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids), 1,
        hw_q, hw_k, hw_k[1] // 2, need_topk=False)
    return np.asarray(msg)


@pytest.mark.parametrize("B,H,D,hw_q,hw_k,K", [
    (2, 3, 8, (8, 8), (8, 8), 3),
    # non-square grids; P = 80 parents takes the Pallas kernel's padding path
    (1, 2, 16, (16, 20), (16, 20), 4),
])
def test_quadtree_fine_plain_matches_pallas_and_oracle(B, H, D, hw_q, hw_k,
                                                       K):
    q, k, v, ids = _fine_case(0, B, H, D, hw_q, hw_k, K)
    got = quadtree_fine_attention_plain(_t(q), _t(k), _t(v), _t(ids), hw_q,
                                        hw_k)
    pallas, _, _ = masked_fine_level(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(ids), hw_q,
                                     hw_k, topk=0, interpret=True)
    _close(got, pallas)
    _close(got, _jax_fine_oracle(q, k, v, ids, hw_q, hw_k))


def test_quadtree_fine_duplicate_ids_match_oracle():
    """Repeated block ids count once per occurrence, as in the gather
    oracle (the Pallas kernel requires distinct ids; the port does not)."""
    hw = (8, 12)
    q, k, v, ids = _fine_case(1, 1, 2, 8, hw, hw, 5, distinct=False)
    assert any(len(set(ids[0, p, :, h])) < 5
               for p in range(ids.shape[1]) for h in range(2))
    got = quadtree_fine_attention_plain(_t(q), _t(k), _t(v), _t(ids), hw, hw)
    _close(got, _jax_fine_oracle(q, k, v, ids, hw, hw))


def test_quadtree_fine_wrapper_takes_plain_on_cpu():
    hw = (8, 8)
    q, k, v, ids = _fine_case(2, 1, 2, 8, hw, hw, 3)
    kernels.reset_launch_counts()
    got = quadtree_fine_attention(_t(q), _t(k), _t(v), _t(ids), hw, hw)
    want = quadtree_fine_attention_plain(_t(q), _t(k), _t(v), _t(ids), hw,
                                         hw)
    assert torch.equal(got, want)
    assert kernels.LAUNCHES["quadtree_fine_attention"] == 0


def test_intermediate_level_selection_matches_by_message():
    """The intermediate level's top-k selection (kernel A′'s plain version
    on the CPU) picks the same children as the JAX gather path.  Compared
    through the next level's message, which does not depend on the order
    of the selected ids."""
    hw, hw_next, topk = (8, 8), (16, 16), 4
    q, k, v, ids = _fine_case(3, 1, 2, 8, hw, hw, 3)
    msg_t, sel_t = tqt._fine_level_b(_t(q), _t(k), _t(v), _t(ids), topk, hw,
                                     hw, need_topk=True)
    _, msg_j, _, sel_j = jqt._fine_level_b(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids),
        topk, hw, hw, hw[1] // 2, need_topk=True)
    _close(msg_t, msg_j)
    rng = np.random.default_rng(4)
    qn, kn, vn = (rng.standard_normal((1, 256, 2, 8)).astype(np.float32)
                  for _ in range(3))
    nxt_t = quadtree_fine_attention_plain(_t(qn), _t(kn), _t(vn), sel_t,
                                          hw_next, hw_next)
    nxt_j = quadtree_fine_attention_plain(
        _t(qn), _t(kn), _t(vn), _t(np.asarray(sel_j).astype(np.int32)),
        hw_next, hw_next)
    _close(nxt_t, nxt_j)


def _pyramid(seed, sizes, B=1, H=2, D=8):
    rng = np.random.default_rng(seed)
    mk = lambda h, w: rng.standard_normal(  # noqa: E731
        (B, h * w, H, D)).astype(np.float32)
    return ([mk(*s) for s in sizes], [mk(*s) for s in sizes],
            [mk(*s) for s in sizes],
            rng.standard_normal(len(sizes)).astype(np.float32))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_qtatt_b_matches_jax(backend):
    """Whole quadtree attention B (coarse level + intermediate level with
    selection + finest level) against the JAX package's gather path and its
    Pallas path in interpret mode."""
    sizes = [(16, 16), (8, 8), (4, 4)]
    qs, ks, vs, wt = _pyramid(5, sizes)
    got = tqt.qtatt_b([_t(x) for x in qs], [_t(x) for x in ks],
                      [_t(x) for x in vs], sizes, [4, 3, 2], _t(wt))
    gather_ops.set_backend(backend)
    try:
        want = jqt.qtatt_b([jnp.asarray(x) for x in qs],
                           [jnp.asarray(x) for x in ks],
                           [jnp.asarray(x) for x in vs], sizes, [4, 3, 2],
                           jnp.asarray(wt))
    finally:
        gather_ops.set_backend("jnp")
    _close(got, want)


# --------------------------------------------------------------------------
# Kernel B: cascade window scores
# --------------------------------------------------------------------------

def _score_case(seed, C, H1=16, W1=20, w=3, B=1):
    rng = np.random.default_rng(seed)
    P = (H1 // 2) * (W1 // 2)
    q = rng.standard_normal((B, P, 4, C)).astype(np.float32)
    f1 = rng.standard_normal((B, H1, W1, C)).astype(np.float32)
    cy = rng.integers(0, H1 // 2 - w + 1, (B, P))
    cx = rng.integers(0, W1 // 2 - w + 1, (B, P))
    return q, f1, np.stack([cy, cx], -1).astype(np.int32)


@pytest.mark.parametrize("C", [128, 12])
def test_window_patch_score_plain_matches_pallas_and_oracle(C):
    w = 3
    q, f1, corners = _score_case(6, C, w=w)
    got = window_patch_score_plain(_t(q), _t(f1), _t(corners), w)
    _close(got, window_patch_score_pallas(jnp.asarray(q), jnp.asarray(f1),
                                          jnp.asarray(corners), w, True))
    _close(got, window_patch_score_jnp(jnp.asarray(q), jnp.asarray(f1),
                                       jnp.asarray(corners), w))


def test_window_patch_score_flat_clamp_matches_oracle():
    """Corners whose patch runs off the grid: the flat index is clamped into
    [0, H1*W1 - 1] as a whole, not per axis (oracle's clipped gather)."""
    w = 3
    q, f1, corners = _score_case(7, 12, w=w)
    corners[0, :5] = [[-2, 0], [0, 9], [7, 9], [6, 8], [7, -1]]
    got = window_patch_score(_t(q), _t(f1), _t(corners), w)  # CPU -> plain
    _close(got, window_patch_score_jnp(jnp.asarray(q), jnp.asarray(f1),
                                       jnp.asarray(corners), w))


# --------------------------------------------------------------------------
# Kernel C: cascade window cross-attention
# --------------------------------------------------------------------------

def _wca_case(seed, H, D, grid, w, B=1):
    rng = np.random.default_rng(seed)
    L = grid * grid
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    corners = rng.integers(0, grid // 2 - w + 1,
                           (B, L // 4, 2)).astype(np.int32)
    return q, k, v, corners, (grid, grid), (grid, grid), w


@pytest.mark.parametrize("H,D,grid,w", [
    (2, 8, 16, 2),
    (4, 4, 20, 3),   # P = 100 parents: the Pallas kernel's padding path
])
def test_window_cross_attention_plain_matches_pallas_and_oracle(H, D, grid,
                                                                w):
    q, k, v, corners, hw_q, hw_k, w = _wca_case(8, H, D, grid, w)
    got = window_cross_attention_plain(_t(q), _t(k), _t(v), _t(corners),
                                       hw_q, hw_k, w)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(corners), hw_q, hw_k, w)
    _close(got, jax_wca(*args, True))
    _close(got, window_cross_attention_oracle(*args))


@pytest.mark.parametrize("H,D", [(4, 32), (2, 12), (3, 20)])
def test_window_cross_attention_any_head_geometry_matches_oracle(H, D):
    """The flagship's head geometry, then D that does not divide 128 and an
    odd head count: outside the Pallas kernel's gates, inside the port's."""
    q, k, v, corners, hw_q, hw_k, w = _wca_case(9, H, D, 12, 2)
    got = window_cross_attention(_t(q), _t(k), _t(v), _t(corners), hw_q,
                                 hw_k, w)  # CPU -> plain
    _close(got, window_cross_attention_oracle(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(corners),
        hw_q, hw_k, w))


def test_cascade_qtatt_b_matches_jax():
    """The structured cascade cross-attention (kernel C on the card) with
    real boundary-shifted windows from window_warp_idx, against the JAX
    package's gather path: same message and upsampled candidate ids."""
    rng = np.random.default_rng(10)
    B, H, D, w, G = 1, 2, 8, 3, 12
    q, k, v = (rng.standard_normal((B, G * G, H, D)).astype(np.float32)
               for _ in range(3))
    prev = rng.integers(0, (G // 2) ** 2, (B, (G // 2) ** 2)).astype(np.int32)
    offsets, _ = jax_propagations("window", w)
    win, _ = jax_window_warp_idx(jnp.asarray(prev), offsets, G // 2, G // 2)
    want_m, want_u = jqt.cascade_qtatt_b(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), win, (G, G), (G, G),
        window_structured=True)
    got_m, got_u = tqt.cascade_qtatt_b(_t(q), _t(k), _t(v),
                                       _t(np.asarray(win)).long(), (G, G),
                                       (G, G), window_structured=True)
    _close(got_m, want_m)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


def test_kernel_wrappers_reject_other_devices():
    """A tensor on neither the CPU nor CUDA raises instead of falling
    back."""
    q = torch.zeros((1, 16, 1, 4), device="meta")
    with pytest.raises(ValueError):
        quadtree_fine_attention(q, q, q, torch.zeros((1, 4, 1, 1),
                                                     dtype=torch.int32,
                                                     device="meta"),
                                (4, 4), (4, 4))
    with pytest.raises(ValueError):
        window_cross_attention(q, q, q, torch.zeros((1, 4, 2),
                                                    dtype=torch.int32,
                                                    device="meta"),
                               (4, 4), (4, 4), 1)
    with pytest.raises(ValueError):
        window_patch_score(torch.zeros((1, 4, 4, 4), device="meta"),
                           torch.zeros((1, 4, 4, 4), device="meta"),
                           torch.zeros((1, 4, 2), dtype=torch.int32,
                                       device="meta"), 1)
