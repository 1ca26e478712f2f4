"""The chunk recurrence of CUDA kernels C and C-bwd (window cross-attention
and its backward), modelled in PyTorch on the CPU.

The kernels run one block per (batch, parent) and stream the parent's 4w^2
candidates through shared memory in chunks (``csrc/window_chunk.cuh``): the
forward keeps FlashAttention's running max and sum per (child, head) row
and rescales its accumulator chunk by chunk; the backward recomputes each
chunk's probabilities from the forward's log-sum-exp, accumulates dq across
chunks and adds each chunk's dK/dV rows.  A CUDA kernel cannot run here,
so the model below repeats that loop (its chunk size read from the kernel
source) and is held against the plain versions (the kernels' oracles on the
card) and the JAX package's jnp oracle and its gradient, on the same numpy
inputs: a tail chunk, fewer candidates than a chunk (w = 1), H*D not a
multiple of 4, both recipes' head geometries, and corners that run past
the grid edge or are negative (the flat clipped-gather rule)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops.pallas.window_kernels import \
    window_cross_attention_oracle  # noqa: E402
from casmtr_tpu_torch.ops.kernels.window_kernels import (  # noqa: E402
    window_cross_attention_bwd_plain, window_cross_attention_plain)

ATOL = 1e-5  # f32, sums in another order
CHUNK_SRC = (Path(__file__).resolve().parents[1] / "casmtr_tpu_torch"
             / "csrc" / "window_chunk.cuh")


def kernel_chunk(H):
    """Candidates per chunk for H heads, by the kernels' rule
    (``chunk_rows`` in window_chunk.cuh): kChunkPairs / H rounded down to a
    power of two, at most 32, at least 1."""
    pairs = int(re.search(r"kChunkPairs = (\d+);",
                          CHUNK_SRC.read_text()).group(1))
    c = min(32, max(1, pairs // H))
    return 1 << (c.bit_length() - 1)


def candidates(corners, w, grid_k):
    """Flat candidate rows [B, P, 4w^2] in the kernels' order, under the
    clipped-gather rule (a negative index counts once from the end, then
    clamps), computed here with numpy."""
    h1, w1 = grid_k
    off = np.asarray([(2 * wy + dr, 2 * wx + dc) for wy in range(w)
                      for wx in range(w) for dr in range(2)
                      for dc in range(2)])
    rows = corners[..., :1].astype(np.int64) * 2 + off[:, 0]
    cols = corners[..., 1:].astype(np.int64) * 2 + off[:, 1]
    idx = rows * w1 + cols
    n = h1 * w1
    return np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)


def child_rows(grid_q):
    """Query rows [P, 4] of each parent's 2x2 children (row-major)."""
    h0, w0 = grid_q
    pr, pc = np.divmod(np.arange((h0 // 2) * (w0 // 2)), w0 // 2)
    return np.stack([(2 * pr + f // 2) * w0 + 2 * pc + f % 2
                     for f in range(4)], -1)


def chunked_forward(q, k, v, corners, grid_q, grid_k, w, chunk):
    """Kernel C's loop: online softmax over chunks of candidates.  Returns
    msg [B, P, 4, H, D] and lse [B, P, 4, H]."""
    B, _, H, D = q.shape
    scale = D ** -0.5
    idx = torch.from_numpy(candidates(corners.numpy(), w, grid_k))
    bi = torch.arange(B)[:, None, None]
    qb = q[:, torch.from_numpy(child_rows(grid_q))]          # [B, P, 4, H, D]
    m = torch.full(qb.shape[:-1], -np.inf)
    l = torch.zeros(qb.shape[:-1])
    acc = torch.zeros(qb.shape)
    for c0 in range(0, idx.shape[-1], chunk):
        rows = idx[..., c0:c0 + chunk]
        kc, vc = k[bi, rows], v[bi, rows]                     # [B, P, c, H, D]
        s = torch.einsum("bpfhd,bpchd->bpfhc", qb, kc) * scale
        m_new = torch.maximum(m, s.amax(-1))
        a = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * a + p.sum(-1)
        acc = acc * a[..., None] + torch.einsum("bpfhc,bpchd->bpfhd", p, vc)
        m = m_new
    return acc / l[..., None], m + torch.log(l)


def chunked_backward(q, k, v, corners, out, lse, g, grid_q, grid_k, w,
                     chunk):
    """Kernel C-bwd's loop: per chunk, P from the LSE, dS, dq accumulated,
    the chunk's dK/dV rows added.  Returns dq, dk, dv."""
    B, Lk, H, D = k.shape
    scale = D ** -0.5
    idx = torch.from_numpy(candidates(corners.numpy(), w, grid_k))
    bi = torch.arange(B)[:, None, None]
    qrows = torch.from_numpy(child_rows(grid_q))
    qb = q[:, qrows]
    delta = (g * out).sum(-1)
    dq_acc = torch.zeros(qb.shape)
    dk, dv = torch.zeros(B * Lk, H, D), torch.zeros(B * Lk, H, D)
    for c0 in range(0, idx.shape[-1], chunk):
        rows = idx[..., c0:c0 + chunk]
        kc, vc = k[bi, rows], v[bi, rows]
        p = torch.exp(torch.einsum("bpfhd,bpchd->bpfhc", qb, kc) * scale
                      - lse[..., None])
        dp = torch.einsum("bpfhd,bpchd->bpfhc", g, vc)
        ds = p * (dp - delta[..., None])
        dq_acc += torch.einsum("bpfhc,bpchd->bpfhd", ds, kc)
        dst = (bi * Lk + rows).reshape(-1)
        dk.index_add_(0, dst, (torch.einsum("bpfhc,bpfhd->bpchd", ds, qb)
                               * scale).flatten(0, 2))
        dv.index_add_(0, dst, torch.einsum("bpfhc,bpfhd->bpchd", p,
                                           g).flatten(0, 2))
    dq = torch.zeros_like(q)
    dq[:, qrows] = dq_acc * scale
    return dq, dk.reshape(k.shape), dv.reshape(v.shape)


def _case(seed, H, D, grid, w, edge, B=1):
    """Inputs on a grid x grid query and key grid; ``edge`` draws corners
    from a range that leaves the grid on every side, else in range."""
    rng = np.random.default_rng(seed)
    L, half = grid * grid, grid // 2
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32)
               for _ in range(3))
    lo, hi = (-2, half - w + 3) if edge else (0, half - w + 1)
    corners = rng.integers(lo, hi, (B, L // 4, 2)).astype(np.int32)
    if edge:   # every corner case at least once
        corners[0, :4] = [[-1, -1], [half - 1, half - 1], [0, half],
                          [-half * half, 3]]
    g = rng.standard_normal((B, L // 4, 4, H, D)).astype(np.float32)
    return q, k, v, corners, g, (grid, grid)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _scatter_close(got, want):
    """dk and dv sum many rows where clipping folds positions together:
    the tolerance scales with the largest magnitude."""
    want = np.asarray(want)
    _close(got, want, ATOL * max(1.0, float(np.abs(want).max())))


CASES = {
    # name: (H, D, grid, w, edge)
    "4c H=4 D=32 tail chunk": (4, 32, 20, 5, False),
    "2c H=2 D=32 tail chunk": (2, 32, 20, 5, False),
    "w=1 below one chunk": (4, 8, 8, 1, False),
    "H=3 D=5 (H*D % 4 != 0)": (3, 5, 12, 3, False),
    "edge and negative corners H=4": (4, 32, 16, 5, True),
    "edge and negative corners H=3 D=5": (3, 5, 12, 3, True),
}


def _inputs(name):
    H, D, grid, w, edge = CASES[name]
    q, k, v, corners, g, hw = _case(list(CASES).index(name), H, D, grid,
                                      w, edge)
    return (q, k, v, corners, g, hw, w), kernel_chunk(H)


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_forward_matches_plain_and_oracle(name):
    (q, k, v, corners, _, hw, w), chunk = _inputs(name)
    NC = 4 * w * w
    assert NC < chunk or NC % chunk   # a partial chunk in every case
    tq, tk, tv, tc = map(torch.from_numpy, (q, k, v, corners))
    msg, lse = chunked_forward(tq, tk, tv, tc, hw, hw, w, chunk)
    want_msg, want_lse = window_cross_attention_plain(tq, tk, tv, tc, hw, hw,
                                                      w, with_lse=True)
    _close(msg, want_msg)
    _close(lse, want_lse)
    _close(msg, window_cross_attention_oracle(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(corners),
        hw, hw, w))


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_backward_matches_plain_and_oracle(name):
    (q, k, v, corners, g, hw, w), chunk = _inputs(name)
    tq, tk, tv, tc, tg = map(torch.from_numpy, (q, k, v, corners, g))
    out, lse = window_cross_attention_plain(tq, tk, tv, tc, hw, hw, w,
                                            with_lse=True)
    got = chunked_backward(tq, tk, tv, tc, out, lse, tg, hw, hw, w, chunk)
    plain = window_cross_attention_bwd_plain(tq, tk, tv, tc, out, lse, tg,
                                             hw, hw, w)
    _, vjp = jax.vjp(lambda a, b, c: window_cross_attention_oracle(
        a, b, c, jnp.asarray(corners), hw, hw, w),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    oracle = vjp(jnp.asarray(g))
    for want in (plain, oracle):
        _close(got[0], want[0])
        _scatter_close(got[1], want[1])
        _scatter_close(got[2], want[2])


@pytest.mark.parametrize("chunk", [1, 3, 7, 100, 128])
def test_chunk_size_does_not_change_the_result(chunk):
    """The recurrence is exact in any chunk size: one candidate at a time,
    sizes that leave a tail, one chunk for all 100 candidates, and more."""
    (q, k, v, corners, g, hw, w), _ = _inputs(
        "edge and negative corners H=4")
    tq, tk, tv, tc, tg = map(torch.from_numpy, (q, k, v, corners, g))
    out, lse = window_cross_attention_plain(tq, tk, tv, tc, hw, hw, w,
                                            with_lse=True)
    msg, got_lse = chunked_forward(tq, tk, tv, tc, hw, hw, w, chunk)
    _close(msg, out)
    _close(got_lse, lse)
    got = chunked_backward(tq, tk, tv, tc, out, lse, tg, hw, hw, w, chunk)
    want = window_cross_attention_bwd_plain(tq, tk, tv, tc, out, lse, tg, hw,
                                            hw, w)
    _close(got[0], want[0])
    _scatter_close(got[1], want[1])
    _scatter_close(got[2], want[2])


def test_kernel_chunk_rule():
    """The chunk sizes the cases above run at: 16 candidates for the 1/4
    level's 4 heads (100 = 6 x 16 + 4), 32 for the 1/2 level's 2 heads
    (100 = 3 x 32 + 4), 16 for 3 heads (36 = 2 x 16 + 4)."""
    assert [kernel_chunk(H) for H in (4, 2, 3, 1, 8, 128)] == \
        [16, 32, 16, 32, 8, 1]
