"""The chunk recurrence of CUDA kernels A, A′ and A-bwd (quadtree fine-level
attention, its top-k form and its backward), modelled in PyTorch on the CPU.

The kernels run one block per (batch, parent), all heads, and stream each
head's 4K candidate key and value slices through shared memory in chunks
(``csrc/chunk_attention.cuh``, candidates ``BlockChildren``): the forward
keeps FlashAttention's running max and sum per (child, head) row and
rescales its accumulator chunk by chunk; A′ keeps every raw score and, after
the last chunk, selects from the numerators exp(s - m_final); the backward
recomputes each chunk's probabilities from the forward's log-sum-exp,
accumulates dq across chunks and adds each chunk's dK/dV rows, once per
occurrence of a key.  A CUDA kernel cannot run here, so the model below
repeats that loop (its chunk size read from the kernel source) and is held
against the plain versions (the kernels' oracles on the card) and the JAX
package on the same numpy inputs: the Pallas kernel in interpret mode and
its gradient for distinct ids, the gather path of ``_fine_level_b`` and its
gradient for repeated ids and for ids outside the block grid (the clipped
gather rule).  Cases: a tail chunk, fewer candidates than a chunk (K = 1),
both main-path K (16 and 32), D = 8, 12 and 32, H = 2 and 8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops import quadtree as jqt  # noqa: E402
from casmtr_tpu.ops.pallas.quadtree_kernels import \
    masked_fine_level  # noqa: E402
from casmtr_tpu_torch.ops.kernels.quadtree_kernels import (  # noqa: E402
    quadtree_fine_attention_bwd_plain, quadtree_fine_attention_plain,
    quadtree_fine_topk_plain)
from tests.torch_parity import child_rows, kernel_chunk  # noqa: E402

ATOL = 1e-5  # f32, sums in another order


def candidate_positions(ids, grid_k):
    """Flat key positions [B, P, H, 4K] of each head's candidates in the
    kernels' order c = kk * 4 + (dr * 2 + dc), under the clipped-gather rule
    (a negative block id counts once from the end, then clamps), computed
    here with numpy."""
    h1, w1 = grid_k
    n_blk = (h1 // 2) * (w1 // 2)
    blk = ids.astype(np.int64)
    blk = np.clip(np.where(blk < 0, blk + n_blk, blk), 0, n_blk - 1)
    j = np.arange(4)
    rows = (blk // (w1 // 2))[..., None] * 2 + j // 2      # [B, P, K, H, 4]
    cols = (blk % (w1 // 2))[..., None] * 2 + j % 2
    B, P, K, H = ids.shape
    return (rows * w1 + cols).transpose(0, 1, 3, 2, 4).reshape(B, P, H, 4 * K)


def _gather(x, pos):
    """Rows x[b, pos[b, p, h, c], h] -> [B, P, H, C, D]."""
    B, _, H, _ = pos.shape
    bi = torch.arange(B)[:, None, None, None]
    hi = torch.arange(H)[None, None, :, None]
    return x[bi, pos, hi]


def chunked_forward(q, k, v, pos, grid_q, chunk):
    """Kernel A's loop: online softmax over chunks of each head's
    candidates.  Returns msg [B, P, 4, H, D], lse [B, P, 4, H], and A′'s
    numerators exp(s - m_final) [B, P, 4, H, 4K] with the final sums."""
    D = q.shape[-1]
    scale = D ** -0.5
    qb = q[:, torch.from_numpy(child_rows(grid_q))]          # [B, P, 4, H, D]
    m = torch.full(qb.shape[:-1], -np.inf)
    l = torch.zeros(qb.shape[:-1])
    acc = torch.zeros(qb.shape)
    scores = []
    for c0 in range(0, pos.shape[-1], chunk):
        rows = pos[..., c0:c0 + chunk]
        kc, vc = _gather(k, rows), _gather(v, rows)         # [B, P, H, c, D]
        s = torch.einsum("bpfhd,bphcd->bpfhc", qb, kc) * scale
        scores.append(s)
        m_new = torch.maximum(m, s.amax(-1))
        a = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * a + p.sum(-1)
        acc = acc * a[..., None] + torch.einsum("bpfhc,bphcd->bpfhd", p, vc)
        m = m_new
    numer = torch.exp(torch.cat(scores, -1) - m[..., None])
    return acc / l[..., None], m + torch.log(l), numer, l


def chunked_selection(numer, l, pos, grid_q, topk):
    """A′'s selection from the chunked numerators: per child row the topk
    largest, ties to the lowest candidate.  Returns score and idx
    [B, Lq, topk, H] at the children's query rows."""
    B, P, _, H, _ = numer.shape
    order = torch.sort(numer, dim=-1, descending=True, stable=True).indices
    sel = order[..., :topk]                                 # [B, P, 4, H, t]
    score = torch.gather(numer, -1, sel) / l[..., None]
    idx = torch.gather(pos[:, :, None].expand(numer.shape), -1, sel)
    qrows = torch.from_numpy(child_rows(grid_q)).reshape(-1)
    out_s = torch.zeros((B, 4 * P, topk, H))
    out_i = torch.zeros((B, 4 * P, topk, H), dtype=torch.long)
    out_s[:, qrows] = score.transpose(3, 4).reshape(B, 4 * P, topk, H)
    out_i[:, qrows] = idx.transpose(3, 4).reshape(B, 4 * P, topk, H)
    return out_s, out_i


def chunked_backward(q, k, v, pos, out, lse, g, grid_q, chunk):
    """Kernel A-bwd's loop: per chunk, P from the LSE, dS, dq accumulated,
    the chunk's dK/dV rows added once per occurrence.  Returns dq, dk,
    dv."""
    B, Lk, H, D = k.shape
    scale = D ** -0.5
    qrows = torch.from_numpy(child_rows(grid_q))
    qb = q[:, qrows]
    delta = (g * out).sum(-1)
    dq_acc = torch.zeros(qb.shape)
    dk, dv = torch.zeros(B * Lk * H, D), torch.zeros(B * Lk * H, D)
    bi = torch.arange(B)[:, None, None, None]
    hi = torch.arange(H)[None, None, :, None]
    for c0 in range(0, pos.shape[-1], chunk):
        rows = pos[..., c0:c0 + chunk]
        kc, vc = _gather(k, rows), _gather(v, rows)
        p = torch.exp(torch.einsum("bpfhd,bphcd->bpfhc", qb, kc) * scale
                      - lse[..., None])
        dp = torch.einsum("bpfhd,bphcd->bpfhc", g, vc)
        ds = p * (dp - delta[..., None])
        dq_acc += torch.einsum("bpfhc,bphcd->bpfhd", ds, kc)
        dst = ((bi * Lk + rows) * H + hi).reshape(-1)
        dk.index_add_(0, dst, (torch.einsum("bpfhc,bpfhd->bphcd", ds, qb)
                               * scale).reshape(-1, D))
        dv.index_add_(0, dst, torch.einsum("bpfhc,bpfhd->bphcd", p,
                                           g).reshape(-1, D))
    dq = torch.zeros_like(q)
    dq[:, qrows] = dq_acc * scale
    return dq, dk.reshape(k.shape), dv.reshape(v.shape)


CASES = {
    # name: (H, D, grid (h, w), K, ids): "distinct" ids (the Pallas kernel's
    # precondition), "repeated", or "clip" (below 0 and past the block grid)
    "finest H=8 D=32 K=16": (8, 32, (8, 8), 16, "distinct"),
    "intermediate H=8 D=32 K=32": (8, 32, (8, 16), 32, "distinct"),
    "tail chunk H=8 D=12 K=3": (8, 12, (8, 8), 3, "distinct"),
    "tail chunk H=2 D=8 K=9": (2, 8, (8, 12), 9, "distinct"),
    "K=1 below one chunk H=2 D=8": (2, 8, (8, 8), 1, "distinct"),
    "repeated ids H=2 D=12 K=5": (2, 12, (8, 12), 5, "repeated"),
    "clip-rule ids H=8 D=8 K=3": (8, 8, (8, 12), 3, "clip"),
}


def _inputs(name, B=1):
    """q, k, v [B, L, H, D], ids [B, P, K, H] int32 and a cotangent
    [B, P, 4, H, D] on one grid for queries and keys, from numpy."""
    H, D, hw, K, kind = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    L = hw[0] * hw[1]
    P = Lb = L // 4
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    if kind == "distinct":
        ids = np.stack([np.stack([np.stack(
            [rng.choice(Lb, size=K, replace=False) for _ in range(H)], -1)
            for _ in range(P)]) for _ in range(B)])
    elif kind == "repeated":
        ids = rng.integers(0, Lb, (B, P, K, H))
        ids[0, 0, :, 0] = ids[0, 0, 0, 0]          # one set all the same
    else:
        ids = rng.integers(-Lb - 3, Lb + 3, (B, P, K, H))
        ids[0, 0, :3, 0] = [-1, -2 * Lb, Lb]      # from the end, clamped
    g = rng.standard_normal((B, P, 4, H, D)).astype(np.float32)
    return q, k, v, ids.astype(np.int32), g, hw, kind


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _scatter_close(got, want):
    """dk and dv sum every occurrence of a key row: the tolerance scales
    with the largest magnitude."""
    want = np.asarray(want)
    _close(got, want, ATOL * max(1.0, float(np.abs(want).max())))


def _jax_message(q, k, v, ids, hw, kind):
    """The JAX package's message: the Pallas kernel in interpret mode for
    distinct ids, the gather path otherwise."""
    if kind == "distinct":
        return masked_fine_level(q, k, v, ids, hw, hw, topk=0,
                                 interpret=True)[0]
    return jqt._fine_level_b(q, k, v, ids, 1, hw, hw, hw[1] // 2,
                             need_topk=False)[1]


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_forward_matches_plain_and_jax(name):
    q, k, v, ids, _, hw, kind = _inputs(name)
    H, K = q.shape[2], ids.shape[2]
    chunk = kernel_chunk(H)
    if kind == "distinct" and K in (1, 3, 9):
        assert 4 * K < chunk or 4 * K % chunk   # a partial chunk
    tq, tk, tv, ti = map(torch.from_numpy, (q, k, v, ids))
    pos = torch.from_numpy(candidate_positions(ids, hw))
    msg, lse, _, _ = chunked_forward(tq, tk, tv, pos, hw, chunk)
    want_msg, want_lse = quadtree_fine_attention_plain(tq, tk, tv, ti, hw, hw,
                                                       with_lse=True)
    _close(msg, want_msg)
    _close(lse, want_lse)
    _close(msg, _jax_message(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(ids), hw, kind))


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_backward_matches_plain_and_jax(name):
    q, k, v, ids, g, hw, kind = _inputs(name)
    tq, tk, tv, ti, tg = map(torch.from_numpy, (q, k, v, ids, g))
    pos = torch.from_numpy(candidate_positions(ids, hw))
    out, lse = quadtree_fine_attention_plain(tq, tk, tv, ti, hw, hw,
                                             with_lse=True)
    got = chunked_backward(tq, tk, tv, pos, out, lse, tg, hw,
                           kernel_chunk(q.shape[2]))
    plain = quadtree_fine_attention_bwd_plain(tq, tk, tv, ti, out, lse, tg,
                                              hw, hw)
    _, vjp = jax.vjp(lambda a, b, c: _jax_message(a, b, c, jnp.asarray(ids),
                                                  hw, kind),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for want in (plain, vjp(jnp.asarray(g))):
        _close(got[0], want[0])
        _scatter_close(got[1], want[1])
        _scatter_close(got[2], want[2])


@pytest.mark.parametrize("name,topk", [
    ("finest H=8 D=32 K=16", 1),
    ("intermediate H=8 D=32 K=32", 16),     # the main path's top 16 of 128
    ("tail chunk H=2 D=8 K=9", 36),          # every candidate
    ("repeated ids H=2 D=12 K=5", 7),
])
def test_chunked_selection_matches_by_message(name, topk):
    """A′'s selection from the chunked numerators against the plain
    version's and the JAX package's (the Pallas kernel's in-kernel top-k in
    interpret mode for a small topk, else the gather path's), by sorted
    scores and through the next level's message, which does not depend on
    the order of the selected ids or on which of two tied candidates was
    taken."""
    q, k, v, ids, _, hw, kind = _inputs(name)
    tq, tk, tv, ti = map(torch.from_numpy, (q, k, v, ids))
    pos = torch.from_numpy(candidate_positions(ids, hw))
    _, _, numer, l = chunked_forward(tq, tk, tv, pos, hw,
                                     kernel_chunk(q.shape[2]))
    score, idx = chunked_selection(numer, l, pos, hw, topk)
    _, p_score, p_idx = quadtree_fine_topk_plain(tq, tk, tv, ti, hw, hw, topk)
    args = tuple(jnp.asarray(x) for x in (q, k, v, ids))
    if kind == "distinct" and topk <= 4:   # (slow in interpret mode)
        _, j_score, j_idx = masked_fine_level(*args, hw, hw, topk=topk,
                                              interpret=True)
    else:
        _, _, j_score, j_idx = jqt._fine_level_b(*args, topk, hw, hw,
                                                 hw[1] // 2)
    hw_next = (2 * hw[0], 2 * hw[1])
    rng = np.random.default_rng(100 + topk)
    nxt = [torch.from_numpy(rng.standard_normal(
        (1, hw_next[0] * hw_next[1], q.shape[2], q.shape[3])).astype(
            np.float32)) for _ in range(3)]
    want = quadtree_fine_attention_plain(*nxt, p_idx, hw_next, hw_next)
    for s, i in ((score, idx), (j_score, j_idx)):
        _close(s, p_score)
        sel = torch.from_numpy(np.asarray(i).astype(np.int32))
        _close(quadtree_fine_attention_plain(*nxt, sel, hw_next, hw_next),
               want)


@pytest.mark.parametrize("chunk", [1, 3, 5, 64, 200])
def test_chunk_size_does_not_change_the_result(chunk):
    """The recurrence is exact in any chunk size: one candidate at a time,
    sizes that leave a tail, one chunk for all 64 candidates, and more."""
    q, k, v, ids, g, hw, _ = _inputs("finest H=8 D=32 K=16")
    tq, tk, tv, ti, tg = map(torch.from_numpy, (q, k, v, ids, g))
    pos = torch.from_numpy(candidate_positions(ids, hw))
    out, lse = quadtree_fine_attention_plain(tq, tk, tv, ti, hw, hw,
                                             with_lse=True)
    msg, got_lse, _, _ = chunked_forward(tq, tk, tv, pos, hw, chunk)
    _close(msg, out)
    _close(got_lse, lse)
    got = chunked_backward(tq, tk, tv, pos, out, lse, tg, hw, chunk)
    want = quadtree_fine_attention_bwd_plain(tq, tk, tv, ti, out, lse, tg, hw,
                                             hw)
    _close(got[0], want[0])
    _scatter_close(got[1], want[1])
    _scatter_close(got[2], want[2])


def test_chunked_model_batch_of_two():
    """A batch of two: each batch row's candidates index its own keys."""
    q, k, v, ids, g, hw, _ = _inputs("repeated ids H=2 D=12 K=5", B=2)
    tq, tk, tv, ti, tg = map(torch.from_numpy, (q, k, v, ids, g))
    pos = torch.from_numpy(candidate_positions(ids, hw))
    chunk = kernel_chunk(2)
    msg, lse, _, _ = chunked_forward(tq, tk, tv, pos, hw, chunk)
    out, want_lse = quadtree_fine_attention_plain(tq, tk, tv, ti, hw, hw,
                                                  with_lse=True)
    _close(msg, out)
    _close(lse, want_lse)
    got = chunked_backward(tq, tk, tv, pos, out, want_lse, tg, hw, chunk)
    want = quadtree_fine_attention_bwd_plain(tq, tk, tv, ti, out, want_lse,
                                             tg, hw, hw)
    _close(got[0], want[0])
    _scatter_close(got[1], want[1])
    _scatter_close(got[2], want[2])


def test_kernel_chunk_rule_for_the_quadtree_levels():
    """The chunk sizes the main path runs at: 8 candidates for the 1/8
    stack's 8 heads, so the finest level's 64 candidates take 8 chunks and
    the intermediate level's 128 take 16; 32 for 2 heads."""
    assert kernel_chunk(8) == 8 and kernel_chunk(2) == 32
    assert [-(-4 * K // kernel_chunk(8)) for K in (16, 32)] == [8, 16]
