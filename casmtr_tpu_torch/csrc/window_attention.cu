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
// (clip_index.cuh).  Output msg[b, p, f, h, :].
//
// What bounds it on an H100: at the 1/4 level of the 832^2 eval (q/k/v
// [1, 43264, 4, 32], w = 5) q, k, v and msg are ~22 MB each and the work is
// ~2.2 GFLOP of f32 arithmetic outside the tensor cores, so the f32
// operation rate bounds it slightly ahead of the bytes (PERF.md holds the
// numbers).  Neighbouring parents' patches overlap, so key/value re-reads
// mostly hit the 50 MB L2.
//
// Design: the TPU kernel's 128-lane f32 planes, block-diagonal head packing
// and the power-of-two-heads, 128 % D == 0 and H*D <= 128 gates existed only
// because Mosaic lowers an unaligned patch DMA for one lane tile alone.  Here
// each warp computes its candidate positions from the corner and runs the
// oracle's arithmetic directly (child_attention.cuh), for any H and D.  One
// warp per (b, p, h); 4 warps per block; scratch in dynamic shared memory.

#include <cuda_runtime.h>

#include "child_attention.cuh"
#include "clip_index.cuh"

namespace casmtr {

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
window_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ corners,
                        float* __restrict__ out,
                        float* __restrict__ lse, int B, int P, int H, int D,
                        int h0, int w0, int h1, int w1, int w, float scale) {
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

  float* qs = smem + (size_t)warp * child_attention_scratch_floats(D, NC);
  float* s = qs + 4 * D;
  int* pos = reinterpret_cast<int*>(s + 4 * NC);

  const int wq2 = w0 / 2;
  const int pr = p / wq2, pc = p % wq2;
  int qrow[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) qrow[f] = (2 * pr + (f >> 1)) * w0 + 2 * pc + (f & 1);

  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  const long long n_pos = (long long)h1 * w1;
  for (int c = lane; c < NC; c += kWarp) {
    const int g = c >> 2;
    const long long row = 2LL * cy + 2 * (g / w) + ((c >> 1) & 1);
    const long long col = 2LL * cx + 2 * (g % w) + (c & 1);
    pos[c] = (int)clip_index(row * w1 + col, n_pos);
  }
  __syncwarp();

  const size_t row_stride = (size_t)H * D;
  const size_t q_off = (size_t)b * h0 * w0 * row_stride + (size_t)h * D;
  const size_t k_off = (size_t)b * h1 * w1 * row_stride + (size_t)h * D;
  float* o = out + (size_t)bp * 4 * row_stride + (size_t)h * D;
  float* l = lse == nullptr ? nullptr : lse + (size_t)bp * 4 * H + h;
  child_attention(q + q_off, k + k_off, v + k_off, o, qrow, pos, NC,
                  (int)row_stride, D, scale, qs, s, l, H, lane);
}

}  // namespace casmtr

// q [B, h0*w0, H, D], k/v [B, h1*w1, H, D], corners [B, P, 2] int32 (y, x)
// on the half key grid with P = (h0/2)*(w0/2), out [B, P, 4, H, D], lse
// [B, P, 4, H] or null (written only when a gradient will be needed); all f32
// contiguous on one device.  Returns the cudaError_t of the launch.
extern "C" int casmtr_window_cross_attention_f32(
    const float* q, const float* k, const float* v, const int* corners,
    float* out, float* lse, int B, int P, int H, int D, int h0, int w0,
    int h1, int w1, int w, float scale, void* stream) {
  using namespace casmtr;
  size_t smem = 0;
  cudaError_t err =
      prepare_child_attention_launch(window_attention_kernel, D, 4 * w * w,
                                     &smem);
  if (err != cudaSuccess) return (int)err;
  const long long tasks = (long long)B * P * H;
  const unsigned blocks =
      (unsigned)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks == 0) return (int)cudaSuccess;
  window_attention_kernel<<<blocks, kWarpsPerBlock * kWarp, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, corners, out, lse, B, P, H, D, h0, w0, h1, w1, w, scale);
  return (int)cudaGetLastError();
}
