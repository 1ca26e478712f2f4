// Backward of the cascade window scores (kernel B-bwd) for Hopper, f32.
//
// Replaces: casmtr_tpu/ops/pallas/window_kernels.py:_bwd, the custom VJP of
// window_patch_score_pallas (plain XLA there: a clipped gather for dq and a
// scatter-add for dfeat1).  Contract: that function, written out as
// window_patch_score_bwd_plain.
//
// What it computes: for the cotangent g [B, P, 4, 4w^2] of kernel B's scores,
//   dq[b, p, f, :]    = sum_c g[b, p, f, c] * feat1[b, pos_c, :]
//   dfeat1[b, spos_c] += sum_f g[b, p, f, c] * q[b, p, f, :]
// with pos_c kernel B's flat candidate index under the clipped-gather rule
// (clip_index.cuh), and spos_c the same flat index under the JAX scatter
// rule of `.at[].add`: a negative index counts once from the end, and an
// index still outside [0, H1*W1) is dropped.  (The model never builds such
// corners; the rule is kept so the kernel follows the JAX package
// everywhere.)
//
// What bounds it on an H100: at the 1/4 level of the 704^2 train step
// (q [1, 7744, 4, 128], feat1 [1, 30976, 128], w = 5) it reads q, feat1 and
// g (16 + 16 + 12 MB) and writes dq and dfeat1 (16 + 16 MB), 76 MB in all
// (23 us at 3.35 TB/s), against ~1.6 GFLOP of f32 work outside the tensor
// cores (24 us at 67 TFLOP/s): bytes and operations bound it about evenly.
// The dfeat1 scatter adds B * P * 4w^2 * C atomic adds (99 M), which land in
// the 50 MB L2 since neighbouring parents' patches overlap.
//
// Design: one block per (b, p), as kernel B.  The cotangent rows and the
// four query rows sit in shared memory; threads run over channels, so each
// candidate row of feat1 is read and each dfeat1 row is updated coalesced.
// dq is written directly (each (b, p) owns its rows); dfeat1 must be zeroed
// by the caller.

#include <cuda_runtime.h>

#include "clip_index.cuh"

namespace casmtr {

constexpr int kScoreBwdThreads = 128;

__global__ void __launch_bounds__(kScoreBwdThreads)
window_score_bwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ feat1,
                        const int* __restrict__ corners,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* dfeat1, int P, int C, int H1, int W1, int w) {
  extern __shared__ float smem[];
  const int NC = 4 * w * w;
  float* gs = smem;                                  // [4, NC]
  float* qs = gs + 4 * NC;                           // [4, C]
  int* pos = reinterpret_cast<int*>(qs + 4 * C);     // [NC] gather rule
  int* spos = pos + NC;                              // [NC] scatter rule
  const long long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int tid = threadIdx.x;

  for (int i = tid; i < 4 * NC; i += kScoreBwdThreads)
    gs[i] = g[bp * 4 * NC + i];
  for (int i = tid; i < 4 * C; i += kScoreBwdThreads)
    qs[i] = q[bp * 4 * C + i];
  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  const long long n_pos = (long long)H1 * W1;
  for (int c = tid; c < NC; c += kScoreBwdThreads) {
    const int gi = c >> 2;
    const long long row = 2LL * cy + 2 * (gi / w) + ((c >> 1) & 1);
    const long long col = 2LL * cx + 2 * (gi % w) + (c & 1);
    long long flat = row * W1 + col;
    pos[c] = (int)clip_index(flat, n_pos);
    if (flat < 0) flat += n_pos;
    spos[c] = (flat < 0 || flat >= n_pos) ? -1 : (int)flat;
  }
  __syncthreads();

  const float* f1 = feat1 + (size_t)b * n_pos * C;
  float* df1 = dfeat1 + (size_t)b * n_pos * C;
  for (int ch = tid; ch < C; ch += kScoreBwdThreads) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    const float q0 = qs[ch], q1 = qs[C + ch], q2 = qs[2 * C + ch],
                q3 = qs[3 * C + ch];
    for (int c = 0; c < NC; ++c) {
      const float g0 = gs[c], g1 = gs[NC + c], g2 = gs[2 * NC + c],
                  g3 = gs[3 * NC + c];
      const float fv = __ldg(f1 + (size_t)pos[c] * C + ch);
      a0 = fmaf(g0, fv, a0);
      a1 = fmaf(g1, fv, a1);
      a2 = fmaf(g2, fv, a2);
      a3 = fmaf(g3, fv, a3);
      if (spos[c] >= 0)
        atomicAdd(df1 + (size_t)spos[c] * C + ch,
                  fmaf(g3, q3, fmaf(g2, q2, fmaf(g1, q1, g0 * q0))));
    }
    float* dqr = dq + bp * 4 * C + ch;
    dqr[0] = a0;
    dqr[C] = a1;
    dqr[2 * C] = a2;
    dqr[3 * C] = a3;
  }
}

}  // namespace casmtr

// q/dq [B, P, 4, C], feat1/dfeat1 [B, H1*W1, C], corners [B, P, 2] int32
// (y, x) on the half grid, g [B, P, 4, 4w^2]; all f32 contiguous on one
// device; dfeat1 zeroed.  Returns the cudaError_t of the launch.
extern "C" int casmtr_window_patch_score_bwd_f32(
    const float* q, const float* feat1, const int* corners, const float* g,
    float* dq, float* dfeat1, int B, int P, int C, int H1, int W1, int w,
    void* stream) {
  using namespace casmtr;
  const int NC = 4 * w * w;
  const size_t smem = (size_t)(4 * NC + 4 * C + 2 * NC) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_score_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * P;
  if (blocks == 0) return (int)cudaSuccess;
  window_score_bwd_kernel<<<(unsigned)blocks, kScoreBwdThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, feat1, corners, g, dq, dfeat1, P, C, H1, W1, w);
  return (int)cudaGetLastError();
}
