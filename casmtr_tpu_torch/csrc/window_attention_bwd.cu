// Backward of the cascade window cross-attention (kernel C-bwd) for Hopper,
// f32.
//
// Replaces: casmtr_tpu/ops/pallas/window_kernels.py:_wca_bwd_kernel (reached
// through window_cross_attention's _wca_bwd -> _wca_bwd_call).  Contract:
// autograd of window_cross_attention_oracle in the same file, written out as
// window_cross_attention_bwd_plain.
//
// What it computes: given q [B, Lq, H, D], k/v [B, Lk, H, D], the patch
// corners of kernel C, its output o and per-row log-sum-exp [B, P, 4, H],
// and the cotangent g of o, FlashAttention's backward over each parent's
// candidate set:
//   P = exp(s - lse) with s = (q . k) * scale, recomputed from the LSE;
//   delta_f = sum_d g[f, d] * o[f, d];
//   dS = P * (g . v - delta);
//   dq_f = scale * sum_c dS[f, c] k_c   (written: each query row belongs to
//                                        exactly one (batch, parent));
//   dk_c += scale * sum_f dS[f, c] q_f,  dv_c += sum_f P[f, c] g_f
// (atomic adds: candidate rows overlap between parents and, where the flat
// clip folds positions together, repeat within one; every occurrence adds,
// as autograd of the gather oracle does, in an order that varies from run
// to run).  The candidates are kernel C's: the 4w^2 positions of the
// (2w x 2w) patch at corners[b, p] * 2, each a FLAT index under the clipped
// take_along_axis rule (clip_index.cuh).
//
// What bounds it on an H100: at the 1/4 level of the 704^2 train step
// (q/k/v [1, 30976, 4, 32], w = 5) each of q, k, v, o, g and the three
// gradients is ~16 MB, against ~4 GFLOP of f32 work outside the tensor cores
// (QK recompute, dP, dQ, dK and dV over 100 candidates), so the f32
// operation rate bounds it slightly ahead of the bytes.  In practice: the
// patch re-reads from the L2 (as kernel C, ~0.8 GB at 176^2), the
// shared-memory traffic, and the dK/dV adds, 2 * B * P * 4w^2 * H * D floats
// (198 M at 176^2), which land in the 50 MB L2 since neighbouring parents'
// patches overlap.
//
// Design (chunk_attention.cuh, candidates WindowPatch): kernel C's block
// per (b, p) and chunk stream of K and V rows.  The q and g rows of all
// heads are staged once, delta and the LSE read once.  Per chunk: P and dS
// with threads over (child pair, head, candidate); then threads over
// (candidate group, 4 floats of the row), for the four children each: dq
// accumulated in registers across chunks, and each candidate's dK and dV
// columns formed in registers and added with one 16-byte
// atomicAdd(float4 *, float4) each (sm_90), a quarter of the instructions
// of scalar adds; a warp covers whole rows, so each add instruction covers
// contiguous bytes.  dq is written once with plain stores.  dk and dv must
// be zeroed by the caller.  Any H and D: H*D up to 2048 floats (512 when
// D % 4 != 0).

#include <cuda_runtime.h>

#include "chunk_attention.cuh"

// q/dq [B, h0*w0, H, D], k/v/dk/dv [B, h1*w1, H, D], corners [B, P, 2] int32
// (y, x) on the half key grid with P = (h0/2)*(w0/2), o/g [B, P, 4, H, D],
// lse [B, P, 4, H]; all f32 contiguous on one device; dk and dv zeroed.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int casmtr_window_cross_attention_bwd_f32(
    const float* q, const float* k, const float* v, const int* corners,
    const float* o, const float* lse, const float* g, float* dq, float* dk,
    float* dv, int B, int P, int H, int D, int h0, int w0, int h1, int w1,
    int w, float scale, void* stream) {
  using namespace casmtr;
  const WindowPatch cand{corners, w, w1, (long long)h1 * w1};
  return (int)dispatch<LaunchBwd<WindowPatch>>(
      (H * D) % 4 == 0 && aligned16(q, k, v, g),
      D % 4 == 0 && aligned16(dq, dk, dv), H * D, q, k, v, cand, o, lse, g,
      dq, dk, dv, B, P, H, D, h0, w0, h1, w1, scale,
      static_cast<cudaStream_t>(stream));
}
