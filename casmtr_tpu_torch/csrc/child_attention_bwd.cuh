// Warp routine of the quadtree attention backward kernel A-bwd
// (quadtree_fine_bwd.cu): one warp computes, for one (batch, parent block,
// head), the gradients of the softmax attention of child_attention.cuh with
// respect to the parent's four child query rows and the NC candidate key
// and value rows whose flat positions are in `pos`.
//
// Layout as in child_attention.cuh: q/k/v and dq/dk/dv rows are [H, D] f32
// per token, passed offset to (batch, token 0, head h), row r at
// base + r * row_stride; the forward output `o` and its cotangent `g` are
// [.., 4, H, D], passed offset to (parent, child 0, head h); the forward's
// log-sum-exp of child f is lse[f * lse_stride].
//
// The arithmetic is FlashAttention's backward over the candidate set:
//   P = exp(s - lse) with s = (q . k) * scale, recomputed from the LSE;
//   delta_f = sum_d g[f, d] * o[f, d];
//   dS = P * (g . v - delta);
//   dq_f = scale * sum_c dS[f, c] k_c   (written: each query row belongs to
//                                        exactly one (batch, parent, head));
//   dk_c += scale * sum_f dS[f, c] q_f,  dv_c += sum_f P[f, c] g_f
// (atomicAdd: candidate rows overlap between parents and, for the quadtree,
// may repeat within one parent; every occurrence adds, as autograd of the
// gather oracle does, in an order that varies from run to run).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "child_attention.cuh"

namespace casmtr {

// Floats of per-warp shared scratch: 4 query rows, 4 cotangent rows, the
// 4 x NC probabilities and dS, NC positions.
__host__ __device__ inline int child_attention_bwd_scratch_floats(int D,
                                                                  int NC) {
  return 8 * D + 8 * NC + NC;
}

__device__ inline void child_attention_bwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ g, const float* __restrict__ lse,
    int lse_stride, float* __restrict__ dq, float* dk, float* dv,
    const int qrow[4], const int* pos, int NC, int row_stride, int D,
    float scale, float* qs, float* gs, float* p, float* ds, int lane) {
  for (int i = lane; i < 4 * D; i += kWarp) {
    const int f = i / D, d = i - f * D;
    qs[i] = q[(size_t)qrow[f] * row_stride + d];
    gs[i] = g[(size_t)f * row_stride + d];
  }
  float delta[4], l[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float acc = 0.f;
    for (int d = lane; d < D; d += kWarp)
      acc = fmaf(g[(size_t)f * row_stride + d], o[(size_t)f * row_stride + d],
                 acc);
    delta[f] = warp_sum(acc);
    l[f] = lse[f * lse_stride];
  }
  __syncwarp();

  // probabilities and dS: lanes over candidates, rows broadcast from smem
  for (int c = lane; c < NC; c += kWarp) {
    const float* kr = k + (size_t)pos[c] * row_stride;
    const float* vr = v + (size_t)pos[c] * row_stride;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; ++d) {
      const float kv = __ldg(kr + d), vv = __ldg(vr + d);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        s[f] = fmaf(qs[f * D + d], kv, s[f]);
        dp[f] = fmaf(gs[f * D + d], vv, dp[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const float pr = expf(s[f] * scale - l[f]);
      p[f * NC + c] = pr;
      ds[f * NC + c] = pr * (dp[f] - delta[f]);
    }
  }
  __syncwarp();

  // dq written, dk/dv scattered: lanes over the head dimension (coalesced)
  for (int d = lane; d < D; d += kWarp) {
    float qd[4], gd[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      qd[f] = qs[f * D + d];
      gd[f] = gs[f * D + d];
    }
    for (int c = 0; c < NC; ++c) {
      const size_t r = (size_t)pos[c] * row_stride + d;
      const float kv = __ldg(k + r);
      float dk_c = 0.f, dv_c = 0.f;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float dsf = ds[f * NC + c];
        acc[f] = fmaf(dsf, kv, acc[f]);
        dk_c = fmaf(dsf, qd[f], dk_c);
        dv_c = fmaf(p[f * NC + c], gd[f], dv_c);
      }
      atomicAdd(dk + r, dk_c * scale);
      atomicAdd(dv + r, dv_c);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f)
      dq[(size_t)qrow[f] * row_stride + d] = acc[f] * scale;
  }
}

// Shared-memory bytes of a block of kWarpsPerBlock backward warps; raises
// the kernel's dynamic shared-memory limit above the default 48 KB.
template <typename Kernel>
inline cudaError_t prepare_child_attention_bwd_launch(Kernel kernel, int D,
                                                      int NC,
                                                      size_t* smem_bytes) {
  *smem_bytes = (size_t)kWarpsPerBlock *
                child_attention_bwd_scratch_floats(D, NC) * sizeof(float);
  if (*smem_bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem_bytes);
  return cudaSuccess;
}

}  // namespace casmtr
