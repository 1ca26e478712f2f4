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
// A design that reads each parent's patch from the L2 sends as many bytes
// of atomic adds back (B * P * 4w^2 * C floats each way: 397 MB at
// 176^2), which land in the 50 MB L2 since neighbouring parents' patches
// overlap; that traffic is the floor of this design.
//
// Design (window_score.cuh): one block of 128 threads per (b, p), as kernel
// B.  The four query rows are staged once; the patch streams through a
// two-stage ring in chunks of 32 candidates by 32 columns (128 floats when
// C % 4 == 0), each with its 4 x 32 cotangents, by 16-byte cp.async, the
// next chunk in flight while the current one computes; channel blocks are
// the outer loop, so a thread's column stays fixed across the candidates.
// Threads run over (candidate group, column of 4 floats): at C = 128, 4
// groups of 32 columns, at C = 64, 8 groups of 16, so every thread has
// work.  Per candidate a thread loads one 16-byte patch word and the 4
// cotangents, adds g[f, c] * patch into its dq registers (4 children x 4
// floats) and forms the candidate's dfeat1 word sum_f g[f, c] * q[f, :]
// from the query column in its registers, added with one
// atomicAdd(float4 *, float4) under the scatter rule (a warp covers
// neighbouring words of rows).  After a channel block's last chunk the
// candidate groups' dq registers are added once through shared memory and
// written.  dfeat1 must be zeroed by the caller.  Any w up to 64 and any C:
// float columns and scalar adds when C % 4 != 0 or an output is not
// 16-byte aligned, 4-byte copies then or when an input is not.

#include <cuda_runtime.h>

#include "window_score.cuh"

namespace casmtr {

// Columns per channel block and candidate groups of a block for C
// channels: every column of a block has a thread in each group.
__host__ __device__ inline int score_bwd_cols(int C, int W) {
  const int cols = (C + W - 1) / W;
  return cols < kScoreCols ? cols : kScoreCols;
}

__host__ __device__ inline int score_bwd_groups(int n_cols) {
  const int g = kThreads / n_cols;
  return g < kScoreChunk ? g : kScoreChunk;
}

template <bool kCopy16, bool kVec>
__global__ void __launch_bounds__(kThreads)
window_score_bwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ feat1,
                        const int* __restrict__ corners,
                        const float* __restrict__ g, float* __restrict__ dq,
                        float* dfeat1, int P, int C, int H1, int W1, int w) {
  constexpr int W = kVec ? 4 : 1;           // floats per column
  constexpr int CH = kScoreChunk;
  extern __shared__ __align__(16) float smem[];
  const int NC = 4 * w * w;
  const int KC = kScoreCols * W;            // floats per channel block
  const int kcb = min(KC, C);               // floats of a full block
  const int S = score_stride<kVec>(kcb);
  const int QS = (C + 3) & ~3;
  const int n_cols = score_bwd_cols(C, W), n_cg = score_bwd_groups(n_cols);
  float* qs = smem;                               // [4][QS]
  float* ring = qs + 4 * QS;                      // [kStages][CH][S]
  float* gring = ring + kStages * CH * S;         // [kStages][4][CH]
  float* red = gring + kStages * 4 * CH;          // [n_cg][4][kcb]
  int* pos = reinterpret_cast<int*>(red + n_cg * 4 * kcb);   // [NC]
  int* spos = pos + NC;                                        // [NC]
  const long long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int tid = threadIdx.x;
  const long long n_pos = (long long)H1 * W1;
  const float* f1 = feat1 + (size_t)b * n_pos * C;
  float* df1 = dfeat1 + (size_t)b * n_pos * C;
  const float* gb = g + bp * 4 * NC;

  patch_positions(corners, bp, w, W1, n_pos, pos, spos);
  __syncthreads();
  // the query rows join chunk 0's copy group
  copy_rows<kCopy16>(qs, QS, q + bp * 4 * C, 4, C,
                     [=](int f) { return (size_t)f * C; });
  const int n_kb = (C + KC - 1) / KC, n_cb = (NC + CH - 1) / CH;
  const int n_chunks = n_kb * n_cb;
  auto issue = [&](int n) {   // chunk n = (channel block, candidate block)
    if (n < n_chunks) {
      const int kb = n / n_cb, c0 = (n - kb * n_cb) * CH, k0 = kb * KC;
      const int cnt = min(CH, NC - c0);
      copy_rows<kCopy16>(ring + (n % kStages) * CH * S, S, f1 + k0, cnt,
                         min(KC, C - k0),
                         [=](int r) { return (size_t)pos[c0 + r] * C; });
      copy_rows<kCopy16>(gring + (n % kStages) * 4 * CH, CH, gb + c0, 4, cnt,
                         [=](int f) { return (size_t)f * NC; });
    }
    cp_async_commit();
  };

  const int cg = tid / n_cols, col = tid - cg * n_cols;
  float dqa[4][W];   // [child f][float of the column]
  float qr[4][W];
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < n_chunks; ++n) {
    issue(n + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int kb = n / n_cb, cb = n - kb * n_cb;
    const int c0 = cb * CH, k0 = kb * KC;
    const int cnt = min(CH, NC - c0), kc = min(KC, C - k0);
    const bool active = cg < n_cg && col * W < kc;
    if (cb == 0 && active) {   // a new channel block
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        load_cols<W>(qr[f], qs + f * QS + k0 + col * W);
#pragma unroll
        for (int e = 0; e < W; ++e) dqa[f][e] = 0.f;
      }
    }
    if (active) {
      const float* st = ring + (n % kStages) * CH * S + col * W;
      const float* gs = gring + (n % kStages) * 4 * CH;
      for (int r = cg; r < cnt; r += n_cg) {
        float p[W];
        load_cols<W>(p, st + r * S);
        const float g0 = gs[r], g1 = gs[CH + r], g2 = gs[2 * CH + r],
                    g3 = gs[3 * CH + r];
        float row[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          dqa[0][e] = fmaf(g0, p[e], dqa[0][e]);
          dqa[1][e] = fmaf(g1, p[e], dqa[1][e]);
          dqa[2][e] = fmaf(g2, p[e], dqa[2][e]);
          dqa[3][e] = fmaf(g3, p[e], dqa[3][e]);
          row[e] = fmaf(g3, qr[3][e],
                        fmaf(g2, qr[2][e], fmaf(g1, qr[1][e], g0 * qr[0][e])));
        }
        const int sp = spos[c0 + r];
        if (sp >= 0) {
          float* dst = df1 + (size_t)sp * C + k0 + col * W;
          if constexpr (W == 4)
            atomicAdd(reinterpret_cast<float4*>(dst),
                      make_float4(row[0], row[1], row[2], row[3]));
          else
            atomicAdd(dst, row[0]);
        }
      }
    }
    if (cb == n_cb - 1) {   // add the candidate groups' dq once
      if (active) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
          store_cols<W>(red + (cg * 4 + f) * kcb + col * W, dqa[f]);
      }
      __syncthreads();
      float* dqb = dq + bp * 4 * C + k0;
      for (int i = tid; i < 4 * kc; i += kThreads) {
        const int f = i / kc, x = i - f * kc;
        float sum = 0.f;
        for (int gi = 0; gi < n_cg; ++gi) sum += red[(gi * 4 + f) * kcb + x];
        dqb[(size_t)f * C + x] = sum;
      }
    }
    __syncthreads();
  }
}

// Shared memory of one block.
inline size_t score_bwd_smem_bytes(int C, int w, bool vec) {
  const int W = vec ? 4 : 1, KC = kScoreCols * W;
  const int kcb = C < KC ? C : KC;
  const int S = vec ? score_stride<true>(kcb) : score_stride<false>(kcb);
  const int n_cg = score_bwd_groups(score_bwd_cols(C, W));
  return (size_t)(4 * ((C + 3) & ~3) + kStages * kScoreChunk * (S + 4) +
                  n_cg * 4 * kcb) *
             sizeof(float) +
         (size_t)2 * 4 * w * w * sizeof(int);
}

struct LaunchScoreBwd {
  template <bool kCopy16, bool kVec>
  static cudaError_t run(const float* q, const float* feat1,
                         const int* corners, const float* g, float* dq,
                         float* dfeat1, int B, int P, int C, int H1, int W1,
                         int w, cudaStream_t stream) {
    auto kernel = window_score_bwd_kernel<kCopy16, kVec>;
    const size_t bytes = score_bwd_smem_bytes(C, w, kVec);
    if (bytes > kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * P;
    if (blocks == 0) return cudaSuccess;
    kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(
        q, feat1, corners, g, dq, dfeat1, P, C, H1, W1, w);
    return cudaGetLastError();
  }
};

}  // namespace casmtr

// q/dq [B, P, 4, C], feat1/dfeat1 [B, H1*W1, C], corners [B, P, 2] int32
// (y, x) on the half grid, g [B, P, 4, 4w^2]; all f32 contiguous on one
// device; dfeat1 zeroed.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue when w is outside 1..kMaxWindow or the block's
// shared memory exceeds 227 KB).
extern "C" int casmtr_window_patch_score_bwd_f32(
    const float* q, const float* feat1, const int* corners, const float* g,
    float* dq, float* dfeat1, int B, int P, int C, int H1, int W1, int w,
    void* stream) {
  using namespace casmtr;
  if (w < 1 || w > kMaxWindow || C < 1) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && aligned16(dq, dfeat1);
  return (int)dispatch_copy<LaunchScoreBwd, true>(
      vec && aligned16(q, feat1, g), vec, q, feat1, corners, g, dq, dfeat1,
      B, P, C, H1, W1, w, static_cast<cudaStream_t>(stream));
}
