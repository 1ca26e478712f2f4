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
// Design (window_chunk.cuh): kernel C's block per (b, p) and chunk stream
// of K and V rows.  The q and g rows of all heads are staged once (and each
// thread's columns of them kept in registers), delta and the LSE read
// once.  Per chunk: P and dS with threads over (child pair, head,
// candidate); then threads over (candidate group, 4 floats of the row), for
// the four children each: dq accumulated in registers across chunks, and
// each candidate's dK and dV columns formed in registers and added with one
// 16-byte atomicAdd(float4 *, float4) each (sm_90), a quarter of the
// instructions of scalar adds; a warp covers whole rows, so each add
// instruction covers contiguous bytes.  dq is written once with plain
// stores.  dk and dv must be zeroed by the caller.  Any H and D: H*D up to
// 2048 floats (512 when D % 4 != 0).

#include <cuda_runtime.h>

#include "window_chunk.cuh"

namespace casmtr {
namespace wca {

// Floats of the backward's shared memory: q and g rows [4][row_stride] each,
// the ring of K and V chunks, the chunk's P and dS [H][prob_stride] each,
// lse and delta [H][4] each, and the ring of positions.
inline size_t bwd_smem_bytes(int H, int D, int CH) {
  const size_t S = row_stride(H * D), R = 4 * H;
  return (8 * S + (size_t)kStages * 2 * CH * kv_stride(H * D) +
          2 * H * (size_t)prob_stride(CH) + 2 * R +
          (size_t)(kStages + 1) * CH) *
         sizeof(float);
}

template <bool kCopy16, bool kVecD, int kSlots>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ corners,
                            const float* __restrict__ o,
                            const float* __restrict__ lse,
                            const float* __restrict__ g,
                            float* __restrict__ dq, float* dk, float* dv,
                            int P, int H, int D, int h0, int w0, int h1,
                            int w1, int w, int CH, float scale) {
  constexpr int W = kVecD ? 4 : 1;       // floats per column
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int HD = H * D, S = row_stride(HD), SK = kv_stride(HD), R = 4 * H;
  const int PS = prob_stride(CH), NC = 4 * w * w;
  const int n_chunks = (NC + CH - 1) / CH, n_cg = candidate_groups(CH, HD / W);
  const bool swz = swizzled(HD);
  // probabilities in base 2: scores and the LSE carry log2(e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  float* qs = smem;                                // [4][S]
  float* gs = qs + 4 * S;                          // [4][S]
  float* kv = gs + 4 * S;                          // [kStages][2][CH][SK]
  float* pb = kv + (size_t)kStages * 2 * CH * SK;  // [H][PS]: P [c][f]
  float* db = pb + H * PS;                         // [H][PS]: dS [c][f]
  float* lse_s = db + H * PS;   // [H][4], row h * 4 + f, times log2(e)
  float* delta = lse_s + R;                        // [H][4]
  int* pos = reinterpret_cast<int*>(delta + R);    // [kStages + 1][CH]

  const long long bp = blockIdx.x;
  const int p = (int)(bp % P), b = (int)(bp / P);
  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  const long long n_pos = (long long)h1 * w1;
  const size_t k_off = (size_t)b * n_pos * HD;
  const float* kb = k + k_off;
  const float* vb = v + k_off;
  const float* ob = o + (size_t)bp * 4 * HD;
  const float* gb = g + (size_t)bp * 4 * HD;
  const float* qb = q + (size_t)b * h0 * w0 * HD;
  const ChunkStream<kCopy16> stream{kv, pos, kb, vb, CH, NC, SK, HD, swz};

  for (int n = 0; n < kStages; ++n)
    chunk_positions(pos, n, CH, NC, cy, cx, w, w1, n_pos);
  // delta = rowsum(g * o) and the LSE per (head, child) row: a warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < R; r += kThreads / 32) {
    const int h = r / 4, f = r - h * 4, off = f * HD + h * D;
    float x = 0.f;
    for (int d = lane; d < D; d += 32) x = fmaf(gb[off + d], ob[off + d], x);
    x = group_sum(x, 32);
    if (lane == 0) {
      delta[r] = x;
      lse_s[r] = lse[bp * R + f * H + h] * kLog2e;
    }
  }
  __syncthreads();
  stream.stage_rows(8, [=](int r) {   // q rows 0-3, g rows 4-7
    return r < 4 ? RowCopy{qs + r * S, qb + (size_t)query_row(p, w0, r) * HD}
                 : RowCopy{gs + (r - 4) * S, gb + (size_t)(r - 4) * HD};
  });
  for (int n = 0; n < kStages - 1; ++n) stream.issue(n);

  const Columns<W, kSlots> col(HD, D, n_cg);
  float qr[kSlots][4][W], gr[kSlots][4][W], dqa[kSlots][4][W] = {};
  for (int n = 0; n < n_chunks; ++n) {
    const int cnt = min(CH, NC - n * CH);
    stream.issue(n + kStages - 1);
    stream.wait();
    const float* ks = stream.stage(n);
    const float* vs = ks + (size_t)CH * SK;
    if (n == 0) {   // this thread's columns of the q and g rows
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = col.j[s] < 0 ? 0 : col.j[s];
          load_cols<W>(qr[s][f], qs + f * S + j);
          load_cols<W>(gr[s][f], gs + f * S + j);
        }
    }

    // P and dS: threads over (child pair, head, candidate)
    for (int t = tid; t < 2 * H * CH; t += kThreads) {
      const int c = t % CH, grp = t / CH, h = grp % H, f = 2 * (grp / H);
      if (c >= cnt) continue;
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
      const int key = kv_key(c, swz);
      dot2<kVecD>(qs + f * S + h * D, qs + (f + 1) * S + h * D, ks + c * SK,
                  h * D, key, D, s0, s1);
      dot2<kVecD>(gs + f * S + h * D, gs + (f + 1) * S + h * D, vs + c * SK,
                  h * D, key, D, dp0, dp1);
      const int r = h * 4 + f;
      const float p0 = exp2f(s0 * scale2 - lse_s[r]);
      const float p1 = exp2f(s1 * scale2 - lse_s[r + 1]);
      const int i = h * PS + c * 4 + f;
      *reinterpret_cast<float2*>(pb + i) = make_float2(p0, p1);
      *reinterpret_cast<float2*>(db + i) =
          make_float2(p0 * (dp0 - delta[r]), p1 * (dp1 - delta[r + 1]));
    }
    chunk_positions(pos, n + kStages, CH, NC, cy, cx, w, w1, n_pos);
    __syncthreads();

    // dq, dK and dV: threads over (candidate group, column), the four
    // children each
    if (col.cg < n_cg) {
      const int* pc = chunk_pos(pos, n, CH);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = col.j[s];
        if (j < 0) continue;
        const float* pr = pb + col.h[s] * PS;
        const float* dr = db + col.h[s] * PS;
        for (int c = col.cg; c < cnt; c += n_cg) {
          const float4 pp = ld4(pr + c * 4), dd = ld4(dr + c * 4);
          float kx[W], dkx[W], dvx[W];
          load_cols<W>(kx, ks + c * SK + kv_col(j, kv_key(c, swz)));
#pragma unroll
          for (int e = 0; e < W; ++e) {
            dqa[s][0][e] = fmaf(dd.x, kx[e], dqa[s][0][e]);
            dqa[s][1][e] = fmaf(dd.y, kx[e], dqa[s][1][e]);
            dqa[s][2][e] = fmaf(dd.z, kx[e], dqa[s][2][e]);
            dqa[s][3][e] = fmaf(dd.w, kx[e], dqa[s][3][e]);
            dkx[e] = scale * fmaf(dd.x, qr[s][0][e],
                                  fmaf(dd.y, qr[s][1][e],
                                       fmaf(dd.z, qr[s][2][e],
                                            dd.w * qr[s][3][e])));
            dvx[e] = fmaf(pp.x, gr[s][0][e],
                          fmaf(pp.y, gr[s][1][e],
                               fmaf(pp.z, gr[s][2][e], pp.w * gr[s][3][e])));
          }
          const size_t row = k_off + (size_t)pc[c] * HD + j;
          if constexpr (W == 4) {
            atomicAdd(reinterpret_cast<float4*>(dk + row),
                      make_float4(dkx[0], dkx[1], dkx[2], dkx[3]));
            atomicAdd(reinterpret_cast<float4*>(dv + row),
                      make_float4(dvx[0], dvx[1], dvx[2], dvx[3]));
          } else {
            atomicAdd(dk + row, dkx[0]);
            atomicAdd(dv + row, dvx[0]);
          }
        }
      }
    }
    __syncthreads();
  }

  // add the candidate groups' partial dq ([n_cg][4][H * D] over the K/V ring,
  // free now: every chunk has landed), then write the four dq rows, one
  // owner each: plain stores
  float* red = kv;
  if (col.cg < n_cg) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (col.j[s] < 0) continue;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        store_cols<W>(red + (col.cg * 4 + f) * HD + col.j[s], dqa[s][f]);
    }
  }
  __syncthreads();
  float* dqb = dq + (size_t)b * h0 * w0 * HD;
  const int n_cols = HD / W;
  for (int t = tid; t < 4 * n_cols; t += kThreads) {
    const int f = t / n_cols, j = (t - f * n_cols) * W;
    float x[W] = {};
    for (int gi = 0; gi < n_cg; ++gi) {
      float y[W];
      load_cols<W>(y, red + (gi * 4 + f) * HD + j);
#pragma unroll
      for (int e = 0; e < W; ++e) x[e] += y[e];
    }
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] *= scale;
    store_cols<W>(dqb + (size_t)query_row(p, w0, f) * HD + j, x);
  }
}

struct LaunchBwd {
  template <bool kCopy16, bool kVecD, int kSlots>
  static cudaError_t run(const float* q, const float* k, const float* v,
                         const int* corners, const float* o, const float* lse,
                         const float* g, float* dq, float* dk, float* dv,
                         int B, int P, int H, int D, int h0, int w0, int h1,
                         int w1, int w, float scale, cudaStream_t stream) {
    auto kernel = window_attention_bwd_kernel<kCopy16, kVecD, kSlots>;
    const int CH =
        fit_chunk(H, [H, D](int ch) { return bwd_smem_bytes(H, D, ch); });
    if (CH == 0) return cudaErrorInvalidValue;
    const size_t smem = bwd_smem_bytes(H, D, CH);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * P;
    if (blocks == 0) return cudaSuccess;
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        q, k, v, corners, o, lse, g, dq, dk, dv, P, H, D, h0, w0, h1, w1, w,
        CH, scale);
    return cudaGetLastError();
  }
};

}  // namespace wca
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
  using namespace casmtr::wca;
  return (int)dispatch<LaunchBwd>(
      (H * D) % 4 == 0 && aligned16(q, k, v, g),
      D % 4 == 0 && aligned16(dq, dk, dv), H * D, q, k, v, corners, o, lse,
      g, dq, dk, dv, B, P, H, D, h0, w0, h1, w1, w, scale,
      static_cast<cudaStream_t>(stream));
}
