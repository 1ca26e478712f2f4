// Cascade window cross-attention (kernel C) for Hopper, f32.
//
// Replaces: casmtr_tpu/ops/pallas/window_kernels.py:_wca_fwd_kernel
// (reached through window_cross_attention -> _wca_fwd_call).
// Contract: window_cross_attention_oracle in the same file, ported as
// window_cross_attention_plain.
//
// What it computes: for every (batch b, parent block p, head h) the four
// 2x2 child queries of p attend, with one softmax over the 4w^2 candidates,
// to the (2w x 2w) patch of the key grid whose top-left corner is
// corners[b, p] * 2.  Candidate c = (wy * w + wx) * 4 + (dr * 2 + dc) is the
// key at flat index (2*cy + 2*wy + dr) * w1 + (2*cx + 2*wx + dc), taken under
// the oracle's clipped take_along_axis rule as a FLAT index, not per axis
// (clip_index.cuh).  Output msg[b, p, f, h, :], and when asked the
// log-sum-exp of each softmax row, lse[b, p, f, h].
//
// What bounds it on an H100: at the 1/4 level of the 832^2 eval (q/k/v
// [1, 43264, 4, 32], w = 5) q, k, v and msg are ~22 MB each and the work is
// ~2.2 GFLOP of f32 arithmetic outside the tensor cores, so the f32
// operation rate bounds it slightly ahead of the bytes (PERF.md holds the
// numbers).  In practice the pace is set by re-reading each parent's patch
// from the 50 MB L2 (neighbouring parents' patches overlap): 100 K and V
// rows of 512 B per parent, about 1.1 GB at 208^2, and by the shared-memory
// traffic of staging and reading them.
//
// Design (chunk_attention.cuh, candidates WindowPatch): one block of 128
// threads per (b, p), all heads.  The four child query rows are staged
// once; K and V rows stream through shared memory in chunks with cp.async,
// whole rows in coalesced 16-byte copies, the next chunk in flight while
// one computes.  Per chunk: scores and FlashAttention's online softmax in
// one pass; then P.V with threads over (candidate group, 4 floats of the
// row), each for the four children, accumulating in registers.  The
// message rows are written whole and coalesced.  Any H and D: H*D up to
// 2048 floats (512 when D % 4 != 0).

#include <cuda_runtime.h>

#include "chunk_attention.cuh"

// q [B, h0*w0, H, D], k/v [B, h1*w1, H, D], corners [B, P, 2] int32 (y, x)
// on the half key grid with P = (h0/2)*(w0/2), out [B, P, 4, H, D], lse
// [B, P, 4, H] or null (written only when a gradient will be needed); all f32
// contiguous on one device.  Returns the cudaError_t of the launch.
extern "C" int casmtr_window_cross_attention_f32(
    const float* q, const float* k, const float* v, const int* corners,
    float* out, float* lse, int B, int P, int H, int D, int h0, int w0,
    int h1, int w1, int w, float scale, void* stream) {
  using namespace casmtr;
  const WindowPatch cand{corners, w, w1, (long long)h1 * w1};
  return (int)dispatch<LaunchFwd<WindowPatch, false>>(
      (H * D) % 4 == 0 && aligned16(q, k, v), D % 4 == 0 && aligned16(out),
      H * D, q, k, v, cand, out, lse, TopkOut{}, B, P, H, D, h0, w0, h1, w1,
      scale, static_cast<cudaStream_t>(stream));
}
