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
// (clip_index.cuh).  Output msg[b, p, f, h, :], and when asked the
// log-sum-exp of each softmax row, lse[b, p, f, h].
//
// What bounds it on an H100: at the 1/4 level of the 832^2 eval (q/k/v
// [1, 43264, 4, 32], w = 5) q, k, v and msg are ~22 MB each and the work is
// ~2.2 GFLOP of f32 arithmetic outside the tensor cores, so the f32
// operation rate bounds it slightly ahead of the bytes (PERF.md holds the
// numbers).  In practice the pace is set by re-reading each parent's patch
// from the 50 MB L2 (neighbouring parents' patches overlap): 100 K and V
// rows of 512 B per parent, about 1.1 GB at 208^2, and by the shared-memory
// traffic of staging and reading them.
//
// Design (window_chunk.cuh): one block of 128 threads per (b, p), all heads.
// The four child query rows are staged once; K and V rows stream through
// shared memory in chunks with cp.async, whole rows in coalesced 16-byte
// copies, the next chunk in flight while one computes.  Per chunk: scores
// and FlashAttention's online softmax in one pass (threads over child
// pair, head and candidate; a softmax row's running max and sum by warp
// shuffles, the rescale factor kept for the product pass); then P.V with
// threads over (candidate group, 4 floats of the row), each for the four
// children, accumulating in registers.  The message rows are written whole
// and coalesced.  No tensor cores: a (parent, head) has 4 query rows, a
// quarter of an mma tile, over keys of its own, and the 1e-4 f32 tolerance
// rules out TF32.  Any H and D: H*D up to 2048 floats (512 when D % 4 != 0).

#include <cuda_runtime.h>

#include "window_chunk.cuh"

namespace casmtr {
namespace wca {

// Floats of the forward's shared memory: query rows [4][row_stride], the
// ring of K and V chunks, the chunk's probabilities [H][prob_stride], the
// rescale factor, running max and running sum [H][4] each, and the ring
// of positions.
inline size_t fwd_smem_bytes(int H, int D, int CH) {
  const size_t S = row_stride(H * D), R = 4 * H;
  return (4 * S + (size_t)kStages * 2 * CH * kv_stride(H * D) +
          H * (size_t)prob_stride(CH) + 3 * R + (size_t)(kStages + 1) * CH) *
         sizeof(float);
}

template <bool kCopy16, bool kVecD, int kSlots>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ corners,
                        float* __restrict__ out, float* __restrict__ lse,
                        int P, int H, int D, int h0, int w0, int h1, int w1,
                        int w, int CH, float scale) {
  constexpr int W = kVecD ? 4 : 1;       // floats per column
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int HD = H * D, S = row_stride(HD), SK = kv_stride(HD), R = 4 * H;
  const int PS = prob_stride(CH), NC = 4 * w * w;
  const int n_chunks = (NC + CH - 1) / CH, n_cg = candidate_groups(CH, HD / W);
  const bool swz = swizzled(HD);
  // softmax in base 2: scores carry log2(e), the LSE is converted back
  const float scale2 = scale * 1.4426950408889634f;
  float* qs = smem;                                // [4][S]
  float* kv = qs + 4 * S;                          // [kStages][2][CH][SK]
  float* pb = kv + (size_t)kStages * 2 * CH * SK;  // [H][PS]: [c][f]
  float* alpha = pb + H * PS;                      // [H][4], row h * 4 + f
  float* m_run = alpha + R;                        // [H][4]
  float* l_run = m_run + R;                        // [H][4]
  int* pos = reinterpret_cast<int*>(l_run + R);    // [kStages + 1][CH]

  const long long bp = blockIdx.x;
  const int p = (int)(bp % P), b = (int)(bp / P);
  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  const long long n_pos = (long long)h1 * w1;
  const float* kb = k + (size_t)b * n_pos * HD;
  const float* vb = v + (size_t)b * n_pos * HD;
  const float* qb = q + (size_t)b * h0 * w0 * HD;
  const ChunkStream<kCopy16> stream{kv, pos, kb, vb, CH, NC, SK, HD, swz};

  for (int n = 0; n < kStages; ++n)
    chunk_positions(pos, n, CH, NC, cy, cx, w, w1, n_pos);
  for (int i = tid; i < R; i += kThreads) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  __syncthreads();
  stream.stage_rows(4, [=](int f) {
    return RowCopy{qs + f * S, qb + (size_t)query_row(p, w0, f) * HD};
  });
  for (int n = 0; n < kStages - 1; ++n) stream.issue(n);

  const Columns<W, kSlots> col(HD, D, n_cg);
  float acc[kSlots][4][W] = {};
  for (int n = 0; n < n_chunks; ++n) {
    const int cnt = min(CH, NC - n * CH);
    stream.issue(n + kStages - 1);
    stream.wait();
    const float* ks = stream.stage(n);
    const float* vs = ks + (size_t)CH * SK;

    // scores and online softmax: threads over (child pair, head,
    // candidate); a row's CH candidates are CH neighbouring lanes
    for (int t0 = 0; t0 < 2 * H * CH; t0 += kThreads) {
      const int t = t0 + tid;
      const bool ok = t < 2 * H * CH;
      const int c = t % CH, grp = t / CH, h = grp % H, f = 2 * (grp / H);
      const bool valid = ok && c < cnt;
      float s0 = -INFINITY, s1 = -INFINITY;
      if (valid) {
        float a0 = 0.f, a1 = 0.f;
        dot2<kVecD>(qs + f * S + h * D, qs + (f + 1) * S + h * D,
                    ks + c * SK, h * D, kv_key(c, swz), D, a0, a1);
        s0 = a0 * scale2;
        s1 = a1 * scale2;
      }
      const float mx0 = group_max(s0, CH), mx1 = group_max(s1, CH);
      const int r = h * 4 + f;               // rows r and r + 1
      const float old0 = ok ? m_run[r] : 0.f, old1 = ok ? m_run[r + 1] : 0.f;
      const float m0 = fmaxf(old0, mx0), m1 = fmaxf(old1, mx1);
      const float p0 = valid ? exp2f(s0 - m0) : 0.f;
      const float p1 = valid ? exp2f(s1 - m1) : 0.f;
      const float l0 = group_sum(p0, CH), l1 = group_sum(p1, CH);
      if (valid)
        *reinterpret_cast<float2*>(pb + h * PS + c * 4 + f) =
            make_float2(p0, p1);
      __syncwarp();   // the row's lanes have read m_run before it moves
      if (ok && c == 0) {
        const float a0 = exp2f(old0 - m0), a1 = exp2f(old1 - m1);
        alpha[r] = a0;
        alpha[r + 1] = a1;
        l_run[r] = l_run[r] * a0 + l0;
        l_run[r + 1] = l_run[r + 1] * a1 + l1;
        m_run[r] = m0;
        m_run[r + 1] = m1;
      }
    }
    chunk_positions(pos, n + kStages, CH, NC, cy, cx, w, w1, n_pos);
    __syncthreads();

    // P.V: threads over (candidate group, column), the four children each
    if (col.cg < n_cg) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (col.j[s] < 0) continue;
        const float4 a = ld4(alpha + col.h[s] * 4);
        const float af[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int e = 0; e < W; ++e) acc[s][f][e] *= af[f];
        const float* pr = pb + col.h[s] * PS;
        for (int c = col.cg; c < cnt; c += n_cg) {
          const float4 pp = ld4(pr + c * 4);
          float x[W];
          load_cols<W>(x, vs + c * SK + kv_col(col.j[s], kv_key(c, swz)));
#pragma unroll
          for (int e = 0; e < W; ++e) {
            acc[s][0][e] = fmaf(pp.x, x[e], acc[s][0][e]);
            acc[s][1][e] = fmaf(pp.y, x[e], acc[s][1][e]);
            acc[s][2][e] = fmaf(pp.z, x[e], acc[s][2][e]);
            acc[s][3][e] = fmaf(pp.w, x[e], acc[s][3][e]);
          }
        }
      }
    }
    __syncthreads();
  }

  // add the candidate groups' partial sums ([n_cg][4][H * D] over the K/V
  // ring, free now: every chunk has landed), then write the message rows
  // [4][H * D], whole and coalesced
  float* red = kv;
  if (col.cg < n_cg) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (col.j[s] < 0) continue;
#pragma unroll
      for (int f = 0; f < 4; ++f)
        store_cols<W>(red + (col.cg * 4 + f) * HD + col.j[s], acc[s][f]);
    }
  }
  __syncthreads();
  float* ob = out + (size_t)bp * 4 * HD;
  const int n_cols = HD / W;
  for (int t = tid; t < 4 * n_cols; t += kThreads) {
    const int f = t / n_cols, j = (t - f * n_cols) * W;
    float x[W] = {};
    for (int g = 0; g < n_cg; ++g) {
      float y[W];
      load_cols<W>(y, red + (g * 4 + f) * HD + j);
#pragma unroll
      for (int e = 0; e < W; ++e) x[e] += y[e];
    }
    const float inv = 1.f / l_run[(j / D) * 4 + f];
#pragma unroll
    for (int e = 0; e < W; ++e) x[e] *= inv;
    store_cols<W>(ob + f * HD + j, x);
  }
  if (lse != nullptr)
    for (int r = tid; r < R; r += kThreads) {   // output row f * H + h
      const int f = r / H, i = (r - f * H) * 4 + f;
      lse[bp * R + r] = (m_run[i] + log2f(l_run[i])) * 0.6931471805599453f;
    }
}

struct LaunchFwd {
  template <bool kCopy16, bool kVecD, int kSlots>
  static cudaError_t run(const float* q, const float* k, const float* v,
                         const int* corners, float* out, float* lse, int B,
                         int P, int H, int D, int h0, int w0, int h1, int w1,
                         int w, float scale, cudaStream_t stream) {
    auto kernel = window_attention_kernel<kCopy16, kVecD, kSlots>;
    const int CH =
        fit_chunk(H, [H, D](int ch) { return fwd_smem_bytes(H, D, ch); });
    if (CH == 0) return cudaErrorInvalidValue;
    const size_t smem = fwd_smem_bytes(H, D, CH);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * P;
    if (blocks == 0) return cudaSuccess;
    kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
        q, k, v, corners, out, lse, P, H, D, h0, w0, h1, w1, w, CH, scale);
    return cudaGetLastError();
  }
};

}  // namespace wca
}  // namespace casmtr

// q [B, h0*w0, H, D], k/v [B, h1*w1, H, D], corners [B, P, 2] int32 (y, x)
// on the half key grid with P = (h0/2)*(w0/2), out [B, P, 4, H, D], lse
// [B, P, 4, H] or null (written only when a gradient will be needed); all f32
// contiguous on one device.  Returns the cudaError_t of the launch.
extern "C" int casmtr_window_cross_attention_f32(
    const float* q, const float* k, const float* v, const int* corners,
    float* out, float* lse, int B, int P, int H, int D, int h0, int w0,
    int h1, int w1, int w, float scale, void* stream) {
  using namespace casmtr::wca;
  return (int)dispatch<LaunchFwd>(
      (H * D) % 4 == 0 && aligned16(q, k, v), D % 4 == 0 && aligned16(out),
      H * D, q, k, v, corners, out, lse, B, P, H, D, h0, w0, h1, w1, w, scale,
      static_cast<cudaStream_t>(stream));
}
