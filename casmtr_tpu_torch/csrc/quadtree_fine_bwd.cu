// Backward of the quadtree fine-level attention (kernel A-bwd) for Hopper,
// on f32 q/k/v and, for the bf16 training step, on bf16 q/k/v (f32
// arithmetic, saved output, LSE, cotangent and gradients in both).
//
// Replaces: casmtr_tpu/ops/pallas/quadtree_kernels.py:_bwd_kernel (reached
// through _message_bwd -> _shared_bwd -> _bwd_call).  Contract: autograd of
// the gather path of casmtr_tpu/ops/quadtree.py:_fine_level_b, written out as
// quadtree_fine_attention_bwd_plain.
//
// What it computes: given q [B, Lq, H, D], k/v [B, Lk, H, D], the block ids
// of kernel A, its output o and per-row log-sum-exp [B, P, 4, H], and the
// cotangent g of o, the gradients dq [B, Lq, H, D] and dk, dv [B, Lk, H, D]
// (the formulas are in chunk_attention.cuh).  The candidates are kernel
// A's: candidate c = kk * 4 + (dr * 2 + dc) of (p, h) is child (dr, dc) of
// key block ids[b, p, kk, h] under the clipped-gather rule (clip_index.cuh).
//
// What bounds it on an H100: at the finest 88x88 level of the 704^2 train
// step (q/k/v [1, 7744, 8, 32], K = 16) each of q, k, v, o, g and the three
// gradients is ~8 MB (65 MB in all, 0.0193 ms at 3.35 TB/s), against ~1.3
// GFLOP of f32 work outside the tensor cores (the QK recompute, dP, dQ, dK
// and dV products; 0.019 ms at 67 TFLOP/s): bytes and operations bound it
// about evenly; at the 44x44 level (K = 32) the operations do (0.0095 ms).
// In practice: re-reading each (parent, head)'s candidate K and V slices
// from the L2 (254 MB at 88^2), the f32 work, and the dK/dV adds,
// 2 * B * P * H * 4K * D floats (63 M at 88^2), which land in the 50 MB L2
// since neighbouring parents select overlapping key blocks.  The bf16
// instance reads q, k and v at half the bytes and stages 64-byte slices;
// its gradients and adds are the f32 instance's.
//
// Design (chunk_attention.cuh, candidates BlockChildren): kernel A's block
// per (b, p) over all heads and its chunk stream of per-head K and V slices
// in coalesced cp.async copies.  The q and g rows are staged once; per
// chunk P and dS are recomputed from the saved LSE with K and V read from
// shared memory, then dq is accumulated in registers and each candidate's
// dK and dV columns are added with one 16-byte atomicAdd each (scalar when
// D % 4 != 0), so no key row is read from device memory twice.  Duplicate
// ids add once per occurrence.  dk and dv must be zeroed by the caller.
// Any H and D: H*D up to 2048 floats (512 when D % 4 != 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chunk_attention.cuh"

namespace casmtr {

// Kernel A-bwd on q/k/v of element type T (float, or bf16 for the bf16
// training step).  A slice of whole 16-byte words (D % 4 == 0 for floats,
// % 8 for bf16) takes float4 columns and, with aligned inputs, 16-byte
// copies (the f32 instance also copies the cotangent rows); otherwise
// 4-byte copies, which a bf16 slice allows only when D is even and q/k/v
// are 4-byte aligned.
template <typename T>
cudaError_t launch_quadtree_fine_bwd(const T* q, const T* k, const T* v,
                                     const int* ids, const float* o,
                                     const float* lse, const float* g,
                                     float* dq, float* dk, float* dv, int B,
                                     int P, int K, int H, int D, int h0,
                                     int w0, int h1, int w1, float scale,
                                     cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (kBf16 && (D % 2 != 0 || !aligned4(q, k, v)))
    return cudaErrorInvalidValue;
  const BlockChildren cand{ids, K, H, w1, (h1 / 2) * (w1 / 2)};
  // a 16-byte copy stays within one head's slice only when the slice is a
  // whole number of 16-byte words
  const bool vec = D % word_elems<T>() == 0 && aligned16(dq, dk, dv);
  const bool copy16 = vec && aligned16(q, k, v) && (kBf16 || aligned16(g));
  return dispatch<LaunchBwd<BlockChildren, T>, true>(
      copy16, vec, H * D, q, k, v, cand, o, lse, g, dq, dk, dv, B, P, H, D,
      h0, w0, h1, w1, scale, stream);
}

}  // namespace casmtr

// q [B, h0*w0, H, D], k/v [B, h1*w1, H, D], ids [B, P, K, H] int32 with
// P = (h0/2)*(w0/2), o/g [B, P, 4, H, D], lse [B, P, 4, H], dq like q and
// dk/dv like k; all f32 contiguous on one device; dk and dv zeroed.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int casmtr_quadtree_fine_attention_bwd_f32(
    const float* q, const float* k, const float* v, const int* ids,
    const float* o, const float* lse, const float* g, float* dq, float* dk,
    float* dv, int B, int P, int K, int H, int D, int h0, int w0, int h1,
    int w1, float scale, void* stream) {
  return (int)casmtr::launch_quadtree_fine_bwd(
      q, k, v, ids, o, lse, g, dq, dk, dv, B, P, K, H, D, h0, w0, h1, w1,
      scale, static_cast<cudaStream_t>(stream));
}

// The bf16-input instance: q/k/v bf16 with D even and 4-byte aligned
// (16-byte copies when D % 8 == 0 and they are 16-byte aligned); o, lse,
// g and the f32 gradients dq, dk, dv as above.
extern "C" int casmtr_quadtree_fine_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const int* ids, const float* o, const float* lse, const float* g,
    float* dq, float* dk, float* dv, int B, int P, int K, int H, int D,
    int h0, int w0, int h1, int w1, float scale, void* stream) {
  return (int)casmtr::launch_quadtree_fine_bwd(
      q, k, v, ids, o, lse, g, dq, dk, dv, B, P, K, H, D, h0, w0, h1, w1,
      scale, static_cast<cudaStream_t>(stream));
}
