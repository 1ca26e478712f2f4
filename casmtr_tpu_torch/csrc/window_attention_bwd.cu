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
// and the cotangent g of o, the gradients dq [B, Lq, H, D] and dk, dv
// [B, Lk, H, D] (child_attention_bwd.cuh).  The candidates are kernel C's:
// the 4w^2 positions of the (2w x 2w) patch at corners[b, p] * 2, each a
// FLAT index under the clipped take_along_axis rule (clip_index.cuh).
//
// What bounds it on an H100: at the 1/4 level of the 704^2 train step
// (q/k/v [1, 30976, 4, 32], w = 5) each of q, k, v, o, g and the three
// gradients is ~16 MB, against ~4 GFLOP of f32 work outside the tensor cores
// (QK recompute, dP, dQ, dK and dV over 100 candidates), so the f32
// operation rate bounds it slightly ahead of the bytes; the dK/dV scatter
// adds 2 * B * P * H * 4w^2 * D atomic adds (198 M), which land in the 50 MB
// L2 since neighbouring parents' patches overlap.
//
// Design: the TPU kernel's 128-lane planes, block-diagonal head packing and
// VMEM-resident dK/dV accumulators revisited across the sequential grid
// existed only because of Mosaic's DMA and matmul shapes.  Here each warp
// works on one (b, p, h) as kernel C does: it computes its candidate
// positions from the corner, recomputes the probabilities from the saved
// LSE, writes its four dq rows and adds its dk/dv contributions with
// atomics, for any H and D.  One warp per (b, p, h); 4 warps per block;
// scratch in dynamic shared memory.  dk and dv must be zeroed by the caller.

#include <cuda_runtime.h>

#include "child_attention_bwd.cuh"
#include "clip_index.cuh"

namespace casmtr {

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
window_attention_bwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ corners,
                            const float* __restrict__ o,
                            const float* __restrict__ lse,
                            const float* __restrict__ g,
                            float* __restrict__ dq, float* dk, float* dv,
                            int B, int P, int H, int D, int h0, int w0,
                            int h1, int w1, int w, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long task = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (long long)B * P * H) return;  // uniform across the warp
  const int h = (int)(task % H);
  const long long bp = task / H;
  const int p = (int)(bp % P);
  const int b = (int)(bp / P);
  const int NC = 4 * w * w;

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

  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  const long long n_pos = (long long)h1 * w1;
  for (int c = lane; c < NC; c += kWarp) {
    const int gi = c >> 2;
    const long long row = 2LL * cy + 2 * (gi / w) + ((c >> 1) & 1);
    const long long col = 2LL * cx + 2 * (gi % w) + (c & 1);
    pos[c] = (int)clip_index(row * w1 + col, n_pos);
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
  size_t smem = 0;
  cudaError_t err = prepare_child_attention_bwd_launch(
      window_attention_bwd_kernel, D, 4 * w * w, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long tasks = (long long)B * P * H;
  const unsigned blocks =
      (unsigned)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks == 0) return (int)cudaSuccess;
  window_attention_bwd_kernel<<<blocks, kWarpsPerBlock * kWarp, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      q, k, v, corners, o, lse, g, dq, dk, dv, B, P, H, D, h0, w0, h1, w1, w,
      scale);
  return (int)cudaGetLastError();
}
