// Warp routine of the quadtree attention kernels A and A' (quadtree_fine.cu):
// one warp computes, for one (batch, parent block, head), the softmax
// attention of the parent's four 2x2 child queries over NC candidate key
// rows whose flat positions the caller has put in `pos`.
//
// Layout: q/k/v rows are [H, D] f32 per token; the caller passes pointers
// already offset to (batch, token 0, head h), so row r starts at
// base + r * row_stride with row_stride = H * D.  The message of child f is
// written at out + f * row_stride, i.e. into an [.., 4, H, D] output.
//
// The arithmetic is the oracle's: scores = (q . k) * scale, a max-shifted
// softmax over the NC candidates, then the probability-weighted sum of the
// candidate value rows, divided by the softmax denominator at the end.
// When `lse` is not null, the log-sum-exp of child f's scaled scores
// (max + log of the denominator) is written at lse[f * lse_stride]: the
// backward (child_attention_bwd.cuh) recomputes the probabilities from it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace casmtr {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Floats of per-warp shared scratch: 4 query rows, 4 score rows, NC positions.
__host__ __device__ inline int child_attention_scratch_floats(int D, int NC) {
  return 4 * D + 4 * NC + NC;
}

__device__ inline void child_attention(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       float* __restrict__ out,
                                       const int qrow[4], const int* pos,
                                       int NC, int row_stride, int D,
                                       float scale, float* qs, float* s,
                                       float* lse, int lse_stride, int lane) {
  for (int i = lane; i < 4 * D; i += kWarp) {
    const int f = i / D;
    qs[i] = q[(size_t)qrow[f] * row_stride + (i - f * D)];
  }
  __syncwarp();

  // scores: lanes over candidates, the query rows broadcast from shared memory
  for (int c = lane; c < NC; c += kWarp) {
    const float* kr = k + (size_t)pos[c] * row_stride;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = __ldg(kr + d);
      a0 = fmaf(qs[d], kv, a0);
      a1 = fmaf(qs[D + d], kv, a1);
      a2 = fmaf(qs[2 * D + d], kv, a2);
      a3 = fmaf(qs[3 * D + d], kv, a3);
    }
    s[c] = a0 * scale;
    s[NC + c] = a1 * scale;
    s[2 * NC + c] = a2 * scale;
    s[3 * NC + c] = a3 * scale;
  }
  __syncwarp();

  // softmax numerators in place, denominators kept per child
  float inv_l[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float* sf = s + f * NC;
    float m = -INFINITY;
    for (int c = lane; c < NC; c += kWarp) m = fmaxf(m, sf[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < NC; c += kWarp) {
      const float e = expf(sf[c] - m);
      sf[c] = e;
      l += e;
    }
    l = warp_sum(l);
    inv_l[f] = 1.f / l;
    if (lse != nullptr && lane == 0) lse[f * lse_stride] = m + logf(l);
  }
  __syncwarp();

  // value aggregation: lanes over the head dimension (coalesced rows)
  for (int d = lane; d < D; d += kWarp) {
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
    for (int c = 0; c < NC; ++c) {
      const float vv = __ldg(v + (size_t)pos[c] * row_stride + d);
      o0 = fmaf(s[c], vv, o0);
      o1 = fmaf(s[NC + c], vv, o1);
      o2 = fmaf(s[2 * NC + c], vv, o2);
      o3 = fmaf(s[3 * NC + c], vv, o3);
    }
    out[d] = o0 * inv_l[0];
    out[row_stride + d] = o1 * inv_l[1];
    out[2 * row_stride + d] = o2 * inv_l[2];
    out[3 * row_stride + d] = o3 * inv_l[3];
  }
}

// Shared-memory bytes of a block of kWarpsPerBlock warps; raises the
// kernel's dynamic shared-memory limit when the default 48 KB is too small.
template <typename Kernel>
inline cudaError_t prepare_child_attention_launch(Kernel kernel, int D, int NC,
                                                  size_t* smem_bytes) {
  *smem_bytes = (size_t)kWarpsPerBlock *
                child_attention_scratch_floats(D, NC) * sizeof(float);
  if (*smem_bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem_bytes);
  return cudaSuccess;
}

}  // namespace casmtr
