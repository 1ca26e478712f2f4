"""The tiling of CUDA kernels B and B-bwd (cascade window scores and their
backward), modelled in PyTorch on the CPU.

The kernels run one block per (batch, parent) and stream the parent's 4w^2
candidate rows of feat1 through shared memory in chunks of kScoreChunk rows
by kScoreCols columns (of 4 floats when C % 4 == 0, else of 1;
``csrc/window_score.cuh``).  Kernel B walks candidate blocks, and inside
each the channel blocks; thread (quad, slice) sums its columns slice,
slice + kScoreSlices, .. of its quad's 4 candidates for the 4 children, and
the slices are added after the candidate block's last channel block.
Kernel B-bwd walks channel blocks, and inside each the candidate blocks;
candidate group cg of a chunk takes its candidates cg, cg + n_cg, .., sums
their dq terms in registers across the channel block's chunks and adds
each candidate's dfeat1 row under the JAX scatter rule; the groups' dq is
added once at the end of the channel block.  A CUDA kernel cannot run
here, so the model below repeats those loops (the constants read from the
kernel sources) and is held against the plain versions (the kernels'
oracles on the card) and the JAX package, on the same numpy inputs:
window_patch_score_jnp, and jax.vjp of window_patch_score_pallas in
interpret mode (its custom VJP ``_bwd`` directly where corners leave the
grid, which the Pallas forward does not take).  Cases: w = 1, 2, 5, 8 and
12 (beyond the old limit of 8), C = 128, 64, 6, 45 and 256 (one and two
channel blocks, float4 and float columns), a batch of two, and corners past
the grid edge and negative under the gather and the scatter rule."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from casmtr_tpu.ops.pallas import window_kernels as jwk  # noqa: E402
from casmtr_tpu_torch.ops.kernels import window_kernels as twk  # noqa: E402

ATOL = 1e-5  # f32, sums in another order
CSRC = Path(__file__).resolve().parents[1] / "casmtr_tpu_torch" / "csrc"


def _constant(name, header="window_score.cuh"):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / header).read_text()).group(1))


CHUNK = _constant("kScoreChunk")
SLICES = _constant("kScoreSlices")
COLS = _constant("kScoreCols")
THREADS = _constant("kThreads", "block_chunk.cuh")


def candidates(corners, w, W1, n):
    """Flat candidate positions [B, P, 4w^2] in the kernels' order, before
    any index rule."""
    off = twk._candidate_offsets(w)
    rows = corners[..., :1].astype(np.int64) * 2 + off[:, 0]
    cols = corners[..., 1:].astype(np.int64) * 2 + off[:, 1]
    return rows * W1 + cols


def gather_rule(flat, n):
    """The clipped-gather rule: a negative index counts once from the end,
    then clamps into [0, n - 1]."""
    return np.clip(np.where(flat < 0, flat + n, flat), 0, n - 1)


def scatter_rule(flat, n):
    """The JAX scatter rule: a negative index counts once from the end, one
    still outside [0, n) is dropped (-1)."""
    flat = np.where(flat < 0, flat + n, flat)
    return np.where((flat >= 0) & (flat < n), flat, -1)


def column_width(C):
    return 4 if C % 4 == 0 else 1


def bwd_groups(C):
    """Columns of a channel block and candidate groups of kernel B-bwd."""
    W = column_width(C)
    n_cols = min(COLS, -(-C // W))
    return n_cols, min(THREADS // n_cols, CHUNK)


def tiled_scores(q, f1, corners, w):
    """Kernel B's loops: candidate blocks, channel blocks inside, a partial
    sum per (child, candidate, slice), the slices added at the end of the
    candidate block."""
    B, P, _, C = q.shape
    H1, W1 = f1.shape[1:3]
    n, NC = H1 * W1, 4 * w * w
    W = column_width(C)
    KC = COLS * W
    idx = torch.from_numpy(gather_rule(candidates(corners.numpy(), w, W1, n),
                                       n))
    f1f = f1.reshape(B, n, C)
    bi = torch.arange(B)[:, None, None]
    out = torch.zeros((B, P, 4, NC))
    for c0 in range(0, NC, CHUNK):
        rows = idx[..., c0:c0 + CHUNK]
        cnt = rows.shape[-1]
        acc = torch.zeros((B, P, 4, cnt, SLICES))
        for k0 in range(0, C, KC):
            patch = f1f[bi, rows][..., k0:k0 + KC]            # [B, P, cnt, kc]
            n_cols = patch.shape[-1] // W
            part = torch.einsum(
                "bpfjx,bprjx->bpfrj",
                q[..., k0:k0 + KC].reshape(B, P, 4, n_cols, W),
                patch.reshape(B, P, cnt, n_cols, W))
            acc.index_add_(-1, torch.arange(n_cols) % SLICES, part)
        out[..., c0:c0 + cnt] = acc.sum(-1)
    return out


def tiled_backward(q, f1, corners, g, w):
    """Kernel B-bwd's loops: channel blocks, candidate blocks inside, dq per
    candidate group (candidate r of a chunk in group r % n_cg), each
    candidate's dfeat1 row added under the scatter rule, the groups' dq
    added at the end of the channel block."""
    B, P, _, C = q.shape
    H1, W1 = f1.shape[1:3]
    n, NC = H1 * W1, 4 * w * w
    KC = COLS * column_width(C)
    _, n_cg = bwd_groups(C)
    flat = candidates(corners.numpy(), w, W1, n)
    idx = torch.from_numpy(gather_rule(flat, n))
    sidx = torch.from_numpy(scatter_rule(flat, n))
    f1f = f1.reshape(B, n, C)
    bi = torch.arange(B)[:, None, None]
    dq = torch.zeros_like(q)
    df = torch.zeros((B * n, C))
    for k0 in range(0, C, KC):
        kc = min(KC, C - k0)
        part = torch.zeros((B, P, n_cg, 4, kc))
        for c0 in range(0, NC, CHUNK):
            rows = idx[..., c0:c0 + CHUNK]
            cnt = rows.shape[-1]
            patch = f1f[bi, rows][..., k0:k0 + kc]            # [B, P, cnt, kc]
            gc = g[..., c0:c0 + cnt]                          # [B, P, 4, cnt]
            part.index_add_(2, torch.arange(cnt) % n_cg,
                            torch.einsum("bpfr,bprx->bprfx", gc, patch))
            drows = torch.einsum("bpfr,bpfx->bprx", gc, q[..., k0:k0 + kc])
            s = sidx[..., c0:c0 + cnt]
            keep = s >= 0
            dst = (bi * n + s.clamp(min=0))[keep]
            df[:, k0:k0 + kc].index_add_(0, dst, drows[keep])
        dq[..., k0:k0 + kc] = part.sum(2)
    return dq, df.reshape(f1.shape)


CASES = {
    # name: (B, C, grid, w, corners past the edge)
    "w=1 C=128, below one chunk": (1, 128, 8, 1, False),
    "w=2 C=64": (1, 64, 12, 2, False),
    "w=5 C=128, tail chunk": (1, 128, 16, 5, False),
    "w=5 C=64, tail chunk": (1, 64, 16, 5, False),
    "w=8 C=6, float columns": (1, 6, 20, 8, False),
    "w=12 C=45, two channel blocks": (1, 45, 28, 12, False),
    "w=2 C=256, two channel blocks": (1, 256, 8, 2, False),
    "batch 2, w=5 C=128": (2, 128, 12, 5, False),
    "edge corners w=5 C=128": (1, 128, 16, 5, True),
    "edge corners w=2 C=45": (1, 45, 12, 2, True),
    "edge corners batch 2, w=3 C=6": (2, 6, 12, 3, True),
}


def _inputs(name):
    """q [B, P, 4, C], feat1 [B, grid, grid, C], corners [B, P, 2] int32 on
    the half grid (in range, or from a range that leaves the grid on every
    side with every corner case at least once), and the cotangent g, scaled
    by 1 / sqrt(4w^2) so that dq, a sum over the 4w^2 candidates, keeps unit
    scale."""
    B, C, grid, w, edge = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    half = grid // 2
    P = half * half
    q = (rng.standard_normal((B, P, 4, C)) * C ** -0.25).astype(np.float32)
    f1 = (rng.standard_normal((B, grid, grid, C))
          * C ** -0.25).astype(np.float32)
    lo, hi = (-2, half - w + 3) if edge else (0, half - w + 1)
    corners = rng.integers(lo, hi, (B, P, 2)).astype(np.int32)
    if edge:
        corners[0, :4] = [[-1, -1], [half - 1, half - 1], [0, half],
                          [-grid * grid, 3]]
    g = (rng.standard_normal((B, P, 4, 4 * w * w))
         / (2 * w)).astype(np.float32)   # dq of unit scale at every w
    return q, f1, corners, g, w, edge


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _scatter_close(got, want):
    """dfeat1 sums many rows where clipping folds positions together: the
    tolerance scales with the largest magnitude."""
    want = np.asarray(want)
    _close(got, want, ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_scores_match_plain_and_oracle(name):
    q, f1, corners, _, w, edge = _inputs(name)
    tq, tf, tc = map(torch.from_numpy, (q, f1, corners))
    got = tiled_scores(tq, tf, tc, w)
    _close(got, twk.window_patch_score_plain(tq, tf, tc, w))
    args = (jnp.asarray(q), jnp.asarray(f1), jnp.asarray(corners), w)
    _close(got, jwk.window_patch_score_jnp(*args))
    if not edge:
        _close(got, jwk.window_patch_score_pallas(*args, True))


@pytest.mark.parametrize("name", list(CASES))
def test_tiled_backward_matches_plain_and_jax(name):
    q, f1, corners, g, w, edge = _inputs(name)
    tq, tf, tc, tg = map(torch.from_numpy, (q, f1, corners, g))
    got = tiled_backward(tq, tf, tc, tg, w)
    plain = twk.window_patch_score_bwd_plain(tq, tf, tc, tg, w)
    jq, jf, jc = jnp.asarray(q), jnp.asarray(f1), jnp.asarray(corners)
    if edge:
        jax_grads = jwk._bwd(w, True, (jq, jf, jc), jnp.asarray(g))[:2]
    else:
        _, vjp = jax.vjp(lambda a, b: jwk.window_patch_score_pallas(
            a, b, jc, w, True), jq, jf)
        jax_grads = vjp(jnp.asarray(g))
    for want in (plain, jax_grads):
        _close(got[0], want[0])
        _scatter_close(got[1], want[1])


@pytest.mark.parametrize("chunk", [4, 12, 100, 128])
def test_chunk_size_does_not_change_the_result(chunk, monkeypatch):
    """The loops are exact in any chunk of whole quads: one quad, a size
    that leaves a tail, all 100 candidates in one chunk, and more."""
    monkeypatch.setattr(sys.modules[__name__], "CHUNK", chunk)
    q, f1, corners, g, w, _ = _inputs("edge corners w=5 C=128")
    tq, tf, tc, tg = map(torch.from_numpy, (q, f1, corners, g))
    _close(tiled_scores(tq, tf, tc, w),
           twk.window_patch_score_plain(tq, tf, tc, w))
    got = tiled_backward(tq, tf, tc, tg, w)
    want = twk.window_patch_score_bwd_plain(tq, tf, tc, tg, w)
    _close(got[0], want[0])
    _scatter_close(got[1], want[1])


def test_tiling_constants():
    """The shapes the cases above run at: 8 quads of 4 candidates by 16
    slices fill the block (100 = 3 x 32 + 4 candidates at w = 5); B-bwd has
    4 candidate groups of 32 float4 columns at C = 128 and 256, 8 of 16 at
    C = 64, 21 of 6 floats at C = 6, 4 of 32 floats at C = 45; B's narrow
    tile (16 columns) takes only rows of at most 16 columns, which are one
    channel block in either tile; and the wrapper's window limit is the
    kernels'."""
    assert (CHUNK, SLICES, COLS, THREADS) == (32, 16, 32, 128)
    assert CHUNK // 4 * SLICES == THREADS
    assert _constant("kScoreNarrowCols") == SLICES
    assert [bwd_groups(C) for C in (128, 64, 6, 45, 256)] == \
        [(32, 4), (16, 8), (6, 21), (32, 4), (32, 4)]
    assert _constant("kMaxWindow") == twk.MAX_SCORE_WINDOW


def test_score_wrappers_take_windows_beyond_8():
    """w = 12 goes through the public wrapper and the autograd function on
    the CPU (the plain versions); a window beyond the kernels' limit is
    refused on the card's path before any launch."""
    q, f1, corners, g, w, _ = _inputs("w=12 C=45, two channel blocks")
    tq, tf, tc = map(torch.from_numpy, (q, f1, corners))
    _close(twk.window_patch_score(tq, tf, tc, w), tiled_scores(tq, tf, tc, w))
    xs = [tq.clone().requires_grad_(True), tf.clone().requires_grad_(True)]
    out = twk.WindowPatchScore.apply(xs[0], xs[1], tc, w)
    out.backward(torch.from_numpy(g))
    want = tiled_backward(tq, tf, tc, torch.from_numpy(g), w)
    _close(xs[0].grad, want[0])
    _scatter_close(xs[1].grad, want[1])
    big = twk.MAX_SCORE_WINDOW + 1
    with pytest.raises(ValueError, match="window"):
        twk._check_score(torch.zeros((1, 4, 4, 4), device="meta"),
                         torch.zeros((1, 4, 4, 4), device="meta"),
                         torch.zeros((1, 4, 2), dtype=torch.int32,
                                     device="meta"), big)
