// Backward of the quadtree fine-level attention (kernel A-bwd) for Hopper,
// f32.
//
// Replaces: casmtr_tpu/ops/pallas/quadtree_kernels.py:_bwd_kernel (reached
// through _message_bwd -> _shared_bwd -> _bwd_call).  Contract: autograd of
// the gather path of casmtr_tpu/ops/quadtree.py:_fine_level_b, written out as
// quadtree_fine_attention_bwd_plain.
//
// What it computes: given q [B, Lq, H, D], k/v [B, Lk, H, D], the block ids
// of kernel A, its output o and per-row log-sum-exp [B, P, 4, H], and the
// cotangent g of o, the gradients dq [B, Lq, H, D] and dk, dv [B, Lk, H, D]
// (child_attention_bwd.cuh).  The candidates are kernel A's: candidate
// c = kk * 4 + (dr * 2 + dc) of (p, h) is child (dr, dc) of key block
// ids[b, p, kk, h] under the clipped-gather rule (clip_index.cuh).
//
// What bounds it on an H100: at the finest 88x88 level of the 704^2 train
// step (q/k/v [1, 7744, 8, 32], K = 16) each of q, k, v, o, g and the three
// gradients is ~8 MB (65 MB in all, 19 us at 3.35 TB/s), against ~1.3 GFLOP
// of f32 work outside the tensor cores (the QK recompute, dP, dQ, dK and dV
// products; 19 us at 67 TFLOP/s): bytes and operations bound it about
// evenly.  The dK/dV scatter adds 2 * B * P * H * 4K * D atomic adds (63 M
// at the finest level), which land in the 50 MB L2 since neighbouring
// parents share key rows.
//
// Design: the TPU kernel's child-major layout, membership bias over every
// key, base-2 exponentials and prescaled q/g existed only because Mosaic has
// no cheap gather and a sequential grid.  Here each warp works on one
// (b, p, h) as kernel A does: it expands its K block ids into 4K key
// positions, recomputes the scores and probabilities from the saved LSE,
// writes its four dq rows directly and adds its dk/dv contributions with
// atomics.  Duplicate ids add once per occurrence.  One warp per (b, p, h);
// 4 warps per block; scratch in dynamic shared memory.  dk and dv must be
// zeroed by the caller.

#include <cuda_runtime.h>

#include "child_attention_bwd.cuh"
#include "clip_index.cuh"

namespace casmtr {

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
quadtree_fine_bwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ ids,
                         const float* __restrict__ o,
                         const float* __restrict__ lse,
                         const float* __restrict__ g, float* __restrict__ dq,
                         float* dk, float* dv, int B, int P, int K, int H,
                         int D, int h0, int w0, int h1, int w1, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long task = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (long long)B * P * H) return;  // uniform across the warp
  const int h = (int)(task % H);
  const long long bp = task / H;
  const int p = (int)(bp % P);
  const int b = (int)(bp / P);
  const int NC = 4 * K;

  float* qs = smem + (size_t)warp * child_attention_bwd_scratch_floats(D, NC);
  float* gs = qs + 4 * D;
  float* pr = gs + 4 * D;
  float* ds = pr + 4 * NC;
  int* pos = reinterpret_cast<int*>(ds + 4 * NC);

  const int wq2 = w0 / 2;
  const int pr_ = p / wq2, pc = p % wq2;
  int qrow[4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
    qrow[f] = (2 * pr_ + (f >> 1)) * w0 + 2 * pc + (f & 1);

  const int wk2 = w1 / 2;
  const int n_blk = (h1 / 2) * wk2;
  const int* id_ph = ids + (size_t)bp * K * H + h;  // ids[b, p, :, h]
  for (int c = lane; c < NC; c += kWarp) {
    const int blk = (int)clip_index(id_ph[(size_t)(c >> 2) * H], n_blk);
    const int j = c & 3;
    pos[c] = ((blk / wk2) * 2 + (j >> 1)) * w1 + (blk % wk2) * 2 + (j & 1);
  }
  __syncwarp();

  const size_t row_stride = (size_t)H * D;
  const size_t q_off = (size_t)b * h0 * w0 * row_stride + (size_t)h * D;
  const size_t k_off = (size_t)b * h1 * w1 * row_stride + (size_t)h * D;
  const size_t o_off = (size_t)bp * 4 * row_stride + (size_t)h * D;
  child_attention_bwd(q + q_off, k + k_off, v + k_off, o + o_off, g + o_off,
                      lse + (size_t)bp * 4 * H + h, H, dq + q_off,
                      dk + k_off, dv + k_off, qrow, pos, NC, (int)row_stride,
                      D, scale, qs, gs, pr, ds, lane);
}

}  // namespace casmtr

// q/dq [B, h0*w0, H, D], k/v/dk/dv [B, h1*w1, H, D], ids [B, P, K, H] int32
// with P = (h0/2)*(w0/2), o/g [B, P, 4, H, D], lse [B, P, 4, H]; all f32
// contiguous on one device; dk and dv zeroed.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int casmtr_quadtree_fine_attention_bwd_f32(
    const float* q, const float* k, const float* v, const int* ids,
    const float* o, const float* lse, const float* g, float* dq, float* dk,
    float* dv, int B, int P, int K, int H, int D, int h0, int w0, int h1,
    int w1, float scale, void* stream) {
  using namespace casmtr;
  size_t smem = 0;
  cudaError_t err = prepare_child_attention_bwd_launch(
      quadtree_fine_bwd_kernel, D, 4 * K, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long tasks = (long long)B * P * H;
  const unsigned blocks =
      (unsigned)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks == 0) return (int)cudaSuccess;
  quadtree_fine_bwd_kernel<<<blocks, kWarpsPerBlock * kWarp, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      q, k, v, ids, o, lse, g, dq, dk, dv, B, P, K, H, D, h0, w0, h1, w1,
      scale);
  return (int)cudaGetLastError();
}
