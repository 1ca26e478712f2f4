// Cascade window scores (kernel B, "K3") for Hopper, f32.
//
// Replaces: casmtr_tpu/ops/pallas/window_kernels.py:
// _window_patch_score_fwd_impl (the inner `kernel`, reached through
// window_patch_score_pallas).  Contract: window_patch_score_jnp in the same
// file, ported as window_patch_score_plain.
//
// What it computes: out[b, p, f, c] = <q_blk[b, p, f, :], feat1[b, pos_c, :]>
// for the four 2x2 child queries f of parent p and the 4w^2 candidates of the
// (2w x 2w) image1 patch at corners[b, p] * 2, written directly in the
// candidate order c = (wy * w + wx) * 4 + (dr * 2 + dc), with
// pos_c = (2*cy + 2*wy + dr) * W1 + (2*cx + 2*wx + dc) taken as a FLAT index
// under the oracle's clipped take_along_axis rule (clip_index.cuh).
//
// What bounds it on an H100: at the 1/4 level of the 832^2 eval (q_blk
// [1, 10816, 4, 128], feat1 [1, 208, 208, 128], w = 5) it must read 44 MB
// and write 17 MB against ~1.1 GFLOP of f32 work, so device-memory bytes
// bound it (PERF.md holds the numbers).  Patches of neighbouring parents
// overlap, so feat1 re-reads mostly hit the 50 MB L2.
//
// Design: one block per (b, p).  The four query rows sit in shared memory;
// the patch is staged in shared memory kChunk channels at a time (each warp
// loads one candidate row's chunk, coalesced), so any channel count C works
// without a 51 KB patch buffer; each thread keeps up to kMaxOut of the
// 4 * 4w^2 dot products in registers across the chunks and writes them once,
// coalesced.  The TPU kernel's C == 128 requirement (one lane tile for the
// unaligned patch DMA) does not exist here.

#include <cuda_runtime.h>

#include "clip_index.cuh"

namespace casmtr {

constexpr int kScoreThreads = 128;
constexpr int kChunk = 32;
constexpr int kMaxOut = 8;  // 4 * 4w^2 <= kScoreThreads * kMaxOut, i.e. w <= 8

__global__ void __launch_bounds__(kScoreThreads)
window_score_kernel(const float* __restrict__ q,
                    const float* __restrict__ feat1,
                    const int* __restrict__ corners, float* __restrict__ out,
                    int P, int C, int H1, int W1, int w) {
  extern __shared__ float smem[];
  const int NC = 4 * w * w;
  const int n_out = 4 * NC;
  float* qs = smem;                        // [4, C]
  float* patch = qs + 4 * C;               // [NC, kChunk + 1]
  int* pos = reinterpret_cast<int*>(patch + NC * (kChunk + 1));  // [NC]
  const long long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int tid = threadIdx.x;

  for (int i = tid; i < 4 * C; i += kScoreThreads) qs[i] = q[bp * 4 * C + i];
  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  const long long n_pos = (long long)H1 * W1;
  for (int c = tid; c < NC; c += kScoreThreads) {
    const int g = c >> 2;
    const long long row = 2LL * cy + 2 * (g / w) + ((c >> 1) & 1);
    const long long col = 2LL * cx + 2 * (g % w) + (c & 1);
    pos[c] = (int)clip_index(row * W1 + col, n_pos);
  }
  __syncthreads();

  const float* f1 = feat1 + (size_t)b * H1 * W1 * C;
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int dn = min(kChunk, C - c0);
    for (int i = tid; i < NC * kChunk; i += kScoreThreads) {
      const int c = i / kChunk, d = i % kChunk;
      patch[c * (kChunk + 1) + d] =
          d < dn ? f1[(size_t)pos[c] * C + c0 + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kScoreThreads;
      if (o < n_out) {
        const float* qr = qs + (o / NC) * C + c0;
        const float* pr = patch + (o % NC) * (kChunk + 1);
        float a = acc[j];
        for (int d = 0; d < dn; ++d) a = fmaf(qr[d], pr[d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  float* ob = out + bp * n_out;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kScoreThreads;
    if (o < n_out) ob[o] = acc[j];
  }
}

}  // namespace casmtr

// q_blk [B, P, 4, C], feat1 [B, H1*W1, C], corners [B, P, 2] int32 (y, x) on
// the half grid, out [B, P, 4, 4w^2]; all f32 contiguous on one device.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue when w is
// beyond the kernel's kMaxOut register budget).
extern "C" int casmtr_window_patch_score_f32(const float* q, const float* feat1,
                                             const int* corners, float* out,
                                             int B, int P, int C, int H1,
                                             int W1, int w, void* stream) {
  using namespace casmtr;
  const int NC = 4 * w * w;
  if (4 * NC > kScoreThreads * kMaxOut) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(4 * C + NC * (kChunk + 1) + NC) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * P;
  if (blocks == 0) return (int)cudaSuccess;
  window_score_kernel<<<(unsigned)blocks, kScoreThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      q, feat1, corners, out, P, C, H1, W1, w);
  return (int)cudaGetLastError();
}
