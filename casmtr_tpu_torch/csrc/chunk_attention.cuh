// The chunked attention of a parent's four 2x2 child queries over a set of
// candidate keys, forward and backward, on the block-per-parent layout of
// block_chunk.cuh: the bodies of kernels C and C-bwd (window_attention*.cu,
// candidates WindowPatch) and of kernels A, A′ and A-bwd
// (quadtree_fine*.cu, candidates BlockChildren).
//
// Forward: the four child query rows are staged once; K and V rows stream
// through shared memory in chunks.  Per chunk: scores and FlashAttention's
// online softmax in one pass (threads over child pair, head and candidate;
// a softmax row's running max and sum by warp shuffles, in base 2, the
// rescale factor kept for the product pass); then P.V with threads over
// (candidate group, 4 floats of the row), each for the four children,
// accumulating in registers.  The message rows are written whole and
// coalesced, and when asked the log-sum-exp of each softmax row.  With
// kTopk (kernel A′) every raw score also goes to a scores buffer, and at
// the end each softmax row's numerators exp(s - m_final) select its n_topk
// best candidates (select_topk, a group of 4 lanes per row).
//
// Backward: FlashAttention's backward over each parent's candidate set:
//   P = exp(s - lse) with s = (q . k) * scale, recomputed from the LSE;
//   delta_f = sum_d g[f, d] * o[f, d];
//   dS = P * (g . v - delta);
//   dq_f = scale * sum_c dS[f, c] k_c   (written: each query row belongs to
//                                        exactly one (batch, parent));
//   dk_c += scale * sum_f dS[f, c] q_f,  dv_c += sum_f P[f, c] g_f.
// The q and g rows of all heads are staged once (and each thread's columns
// of them kept in registers), delta and the LSE read once.  Per chunk: P
// and dS with threads over (child pair, head, candidate); then threads over
// (candidate group, 4 floats of the row), for the four children each: dq
// accumulated in registers across chunks, and each candidate's dK and dV
// columns formed in registers and added with one 16-byte
// atomicAdd(float4 *, float4) each (sm_90), scalar adds for float columns.
// Candidate rows overlap between parents and may repeat within one: every
// occurrence adds, as autograd of the gather oracles does, in an order that
// varies from run to run.  dk and dv must be zeroed by the caller.
//
// No tensor cores: a (parent, head) has 4 query rows, a quarter of an mma
// tile, over keys of its own, and the 1e-4 f32 tolerance rules out TF32.
// Any H and D: H*D up to 2048 floats (512 when D % 4 != 0).
#pragma once

#include <limits.h>

#include "block_chunk.cuh"

namespace casmtr {

// ---------------------------------------------------------------------------
// candidate sets: begin(bp) once per block, then position(c, h) is the flat
// key position of candidate c of head h, under the oracles' clipped-gather
// rule (clip_index.cuh); kPerHead says whether heads have sets of their own
// ---------------------------------------------------------------------------

// Kernel C's: candidate c = (wy * w + wx) * 4 + (dr * 2 + dc) is the key at
// flat index (2*cy + 2*wy + dr) * w1 + (2*cx + 2*wx + dc) of the (2w x 2w)
// patch at corners[b, p] * 2, clipped as a FLAT index, the same for every
// head.
struct WindowPatch {
  static constexpr bool kPerHead = false;
  const int* corners;
  int w, w1;
  long long n_pos;
  int cy = 0, cx = 0;

  __device__ void begin(long long bp) {
    cy = corners[bp * 2];
    cx = corners[bp * 2 + 1];
  }
  __host__ __device__ int count() const { return 4 * w * w; }
  __device__ int position(int c, int) const {
    const int g = c >> 2;
    const long long row = 2LL * cy + 2 * (g / w) + ((c >> 1) & 1);
    const long long col = 2LL * cx + 2 * (g % w) + (c & 1);
    return (int)clip_index(row * w1 + col, n_pos);
  }
};

// Kernel A's: candidate c = kk * 4 + (dr * 2 + dc) of head h is child
// (dr, dc) of key block ids[b, p, kk, h] (clipped into the (h1/2)*(w1/2)
// blocks) on the (h1, w1) key grid.
struct BlockChildren {
  static constexpr bool kPerHead = true;
  const int* ids;
  int K, H, w1, n_blk;
  const int* mine = nullptr;   // ids[b, p, :, :]

  __device__ void begin(long long bp) { mine = ids + bp * K * H; }
  __host__ __device__ int count() const { return 4 * K; }
  __device__ int position(int c, int h) const {
    const int wk2 = w1 / 2, j = c & 3;
    const int blk = (int)clip_index(mine[(c >> 2) * H + h], n_blk);
    return ((blk / wk2) * 2 + (j >> 1)) * w1 + (blk % wk2) * 2 + (j & 1);
  }
};

// Kernel A′'s selection outputs: score/idx [B, h0*w0, n_topk, H].
struct TopkOut {
  float* score = nullptr;
  int* idx = nullptr;
  int n_topk = 0;
};

// Stride of a softmax row's scores in A′'s buffer: 4 floats of padding put
// 8 consecutive rows 4 banks apart, so the 4-lane groups of select_topk
// that read them at once hit distinct banks.
__host__ __device__ inline int score_stride(int NC) { return NC + 4; }

// The parent's candidate positions [NC][parts] into shared memory.
template <typename Cand>
__device__ void parent_positions(int* pos, const Cand& cand, int NC,
                                 int parts) {
  for (int i = threadIdx.x; i < NC * parts; i += kThreads) {
    const int c = i / parts;
    pos[i] = cand.position(c, i - c * parts);
  }
}

constexpr int kSelLanes = 4;   // lanes per softmax row in select_topk

// Arg-max of (v, c) within aligned groups of kSelLanes lanes: the larger v,
// and on equal v the lower c.  Every lane of a group ends with its winner;
// every lane of the warp must take part.
__device__ __forceinline__ void group_argmax(float& v, int& c) {
#pragma unroll
  for (int o = kSelLanes / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oc = __shfl_xor_sync(0xffffffffu, c, o);
    if (ov > v || (ov == v && oc < c)) {
      v = ov;
      c = oc;
    }
  }
}

// Kernel A′'s selection, after the last chunk: per softmax row
// r = h * 4 + f (a group of kSelLanes lanes each, the block's 32 groups on
// 32 rows at a time), its numerators exp(s - m_final) from the raw base-2
// scores in `sc`, a NaN turned into +inf (it ranks first, while the row's
// probabilities stay NaN through the NaN denominator); then n_topk rounds
// of a group-wide arg-max (lanes stride over the candidates, ties to the
// lowest candidate), the winner pinned to -1 after its round (numerators
// are >= 0), written to score/idx at the child's query row.  The scores
// are consumed.
template <typename Cand>
__device__ void select_topk(float* sc, int SCS, const float* m_run,
                            const float* l_run, int NC, int H,
                            const Cand& cand, const TopkOut& sel, size_t row0,
                            int p, int w0) {
  constexpr int kGroups = kThreads / kSelLanes;
  const int gl = threadIdx.x % kSelLanes, group = threadIdx.x / kSelLanes;
  for (int r0 = 0; r0 < 4 * H; r0 += kGroups) {
    const int r = r0 + group, h = r >> 2, f = r & 3;
    const bool active = r < 4 * H;   // the same for a group's lanes
    float* sf = sc + (size_t)(active ? r : 0) * SCS;
    if (active) {
      const float m = m_run[r];
      for (int c = gl; c < NC; c += kSelLanes) {
        const float x = exp2f(sf[c] - m);
        sf[c] = x != x ? INFINITY : x;
      }
    }
    __syncwarp();
    const float inv_den = active ? 1.f / l_run[r] : 0.f;
    const size_t row =
        active ? (row0 + query_row(p, w0, f)) * sel.n_topk : 0;
    for (int t = 0; t < sel.n_topk; ++t) {
      float best = -INFINITY;  // below every numerator and every pin
      int best_c = INT_MAX;
      if (active)
        for (int c = gl; c < NC; c += kSelLanes) {  // ascending c
          const float x = sf[c];
          if (x > best) {
            best = x;
            best_c = c;
          }
        }
      group_argmax(best, best_c);
      if (active && gl == 0 && best_c < NC) {
        sel.score[(row + t) * H + h] = best * inv_den;
        sel.idx[(row + t) * H + h] = cand.position(best_c, h);
        sf[best_c] = -1.f;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Bytes of the forward's shared memory: query rows [4][row_stride], the
// ring of K and V chunks, the chunk's probabilities [H][prob_stride], the
// rescale factor, running max and running sum [H][4] each, with kTopk the
// scores [4H][score_stride], and the positions [NC][parts].
inline size_t fwd_smem_bytes(int H, int D, int CH, int NC, int parts,
                             bool topk) {
  const size_t S = row_stride(H * D), R = 4 * H;
  return (4 * S + (size_t)kStages * 2 * CH * kv_stride(H * D) +
          H * (size_t)prob_stride(CH) + 3 * R +
          (topk ? R * score_stride(NC) : 0) + (size_t)NC * parts) *
         sizeof(float);
}

template <typename Cand, bool kTopk, bool kCopy16, bool kVecD, int kSlots>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, Cand cand,
                       float* __restrict__ out, float* __restrict__ lse,
                       TopkOut sel, int P, int H, int D, int h0, int w0,
                       int h1, int w1, int CH, float scale) {
  constexpr int W = kVecD ? 4 : 1;       // floats per column
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const long long bp = blockIdx.x;
  const int p = (int)(bp % P), b = (int)(bp / P);
  cand.begin(bp);
  const int HD = H * D, S = row_stride(HD), SK = kv_stride(HD), R = 4 * H;
  const int PS = prob_stride(CH), NC = cand.count(), SCS = score_stride(NC);
  const int parts = Cand::kPerHead ? H : 1;
  const int n_chunks = (NC + CH - 1) / CH, n_cg = candidate_groups(CH, HD / W);
  const bool swz = swizzled(HD);
  // softmax in base 2: scores carry log2(e), the LSE is converted back
  const float scale2 = scale * kLog2e;
  float* qs = smem;                                // [4][S]
  float* kv = qs + 4 * S;                          // [kStages][2][CH][SK]
  float* pb = kv + (size_t)kStages * 2 * CH * SK;  // [H][PS]: [c][f]
  float* alpha = pb + H * PS;                      // [H][4], row h * 4 + f
  float* m_run = alpha + R;                        // [H][4]
  float* l_run = m_run + R;                        // [H][4]
  float* sc = l_run + R;                           // kTopk: [R][SCS]
  int* pos = reinterpret_cast<int*>(sc + (kTopk ? (size_t)R * SCS : 0));

  const size_t k_off = (size_t)b * h1 * w1 * HD;
  const float* qb = q + (size_t)b * h0 * w0 * HD;
  const ChunkStream<kCopy16> stream{kv, pos, k + k_off, v + k_off, CH, NC,
                                    SK, HD, Cand::kPerHead ? D : HD, swz};

  parent_positions(pos, cand, NC, parts);
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
      if (valid) {
        *reinterpret_cast<float2*>(pb + h * PS + c * 4 + f) =
            make_float2(p0, p1);
        if constexpr (kTopk) {
          sc[r * SCS + n * CH + c] = s0;
          sc[(r + 1) * SCS + n * CH + c] = s1;
        }
      }
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
      lse[bp * R + r] = (m_run[i] + log2f(l_run[i])) * kLn2;
    }
  if constexpr (kTopk)
    select_topk(sc, SCS, m_run, l_run, NC, H, cand, sel, (size_t)b * h0 * w0,
                p, w0);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Bytes of the backward's shared memory: q and g rows [4][row_stride] each,
// the ring of K and V chunks, the chunk's P and dS [H][prob_stride] each,
// lse and delta [H][4] each, and the positions [NC][parts].
inline size_t bwd_smem_bytes(int H, int D, int CH, int NC, int parts) {
  const size_t S = row_stride(H * D), R = 4 * H;
  return (8 * S + (size_t)kStages * 2 * CH * kv_stride(H * D) +
          2 * H * (size_t)prob_stride(CH) + 2 * R + (size_t)NC * parts) *
         sizeof(float);
}

template <typename Cand, bool kCopy16, bool kVecD, int kSlots>
__global__ void __launch_bounds__(kThreads)
chunk_attention_bwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, Cand cand,
                           const float* __restrict__ o,
                           const float* __restrict__ lse,
                           const float* __restrict__ g,
                           float* __restrict__ dq, float* dk, float* dv,
                           int P, int H, int D, int h0, int w0, int h1,
                           int w1, int CH, float scale) {
  constexpr int W = kVecD ? 4 : 1;       // floats per column
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const long long bp = blockIdx.x;
  const int p = (int)(bp % P), b = (int)(bp / P);
  cand.begin(bp);
  const int HD = H * D, S = row_stride(HD), SK = kv_stride(HD), R = 4 * H;
  const int PS = prob_stride(CH), NC = cand.count();
  const int parts = Cand::kPerHead ? H : 1;
  const int n_chunks = (NC + CH - 1) / CH, n_cg = candidate_groups(CH, HD / W);
  const bool swz = swizzled(HD);
  // probabilities in base 2: scores and the LSE carry log2(e)
  const float scale2 = scale * kLog2e;
  float* qs = smem;                                // [4][S]
  float* gs = qs + 4 * S;                          // [4][S]
  float* kv = gs + 4 * S;                          // [kStages][2][CH][SK]
  float* pb = kv + (size_t)kStages * 2 * CH * SK;  // [H][PS]: P [c][f]
  float* db = pb + H * PS;                         // [H][PS]: dS [c][f]
  float* lse_s = db + H * PS;   // [H][4], row h * 4 + f, times log2(e)
  float* delta = lse_s + R;                        // [H][4]
  int* pos = reinterpret_cast<int*>(delta + R);    // [NC][parts]

  const size_t k_off = (size_t)b * h1 * w1 * HD;
  const float* ob = o + (size_t)bp * 4 * HD;
  const float* gb = g + (size_t)bp * 4 * HD;
  const float* qb = q + (size_t)b * h0 * w0 * HD;
  const ChunkStream<kCopy16> stream{kv, pos, k + k_off, v + k_off, CH, NC,
                                    SK, HD, Cand::kPerHead ? D : HD, swz};

  parent_positions(pos, cand, NC, parts);
  // delta = rowsum(g * o) and the LSE per (head, child) row: a warp per row
  const int warp = tid / kWarp, lane = tid % kWarp;
  for (int r = warp; r < R; r += kThreads / kWarp) {
    const int h = r / 4, f = r - h * 4, off = f * HD + h * D;
    float x = 0.f;
    for (int d = lane; d < D; d += kWarp) x = fmaf(gb[off + d], ob[off + d], x);
    x = group_sum(x, kWarp);
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
    __syncthreads();

    // dq, dK and dV: threads over (candidate group, column), the four
    // children each
    if (col.cg < n_cg) {
      const int* pc = pos + (size_t)n * CH * parts;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int j = col.j[s];
        if (j < 0) continue;
        const float* pr = pb + col.h[s] * PS;
        const float* dr = db + col.h[s] * PS;
        const int part = Cand::kPerHead ? col.h[s] : 0;
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
          const size_t row = k_off + (size_t)pc[c * parts + part] * HD + j;
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

// ---------------------------------------------------------------------------
// launchers, for dispatch<>: the chunk size that fits, the shared-memory
// limit, one block per (batch, parent)
// ---------------------------------------------------------------------------

template <typename Cand, bool kTopk>
struct LaunchFwd {
  template <bool kCopy16, bool kVecD, int kSlots>
  static cudaError_t run(const float* q, const float* k, const float* v,
                         Cand cand, float* out, float* lse, TopkOut sel,
                         int B, int P, int H, int D, int h0, int w0, int h1,
                         int w1, float scale, cudaStream_t stream) {
    auto kernel = chunk_attention_kernel<Cand, kTopk, kCopy16, kVecD, kSlots>;
    const int NC = cand.count(), parts = Cand::kPerHead ? H : 1;
    auto bytes = [=](int ch) {
      return fwd_smem_bytes(H, D, ch, NC, parts, kTopk);
    };
    const int CH = fit_chunk(H, bytes);
    if (CH == 0) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(kernel, bytes(CH));
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * P;
    if (blocks == 0) return cudaSuccess;
    kernel<<<(unsigned)blocks, kThreads, bytes(CH), stream>>>(
        q, k, v, cand, out, lse, sel, P, H, D, h0, w0, h1, w1, CH, scale);
    return cudaGetLastError();
  }
};

template <typename Cand>
struct LaunchBwd {
  template <bool kCopy16, bool kVecD, int kSlots>
  static cudaError_t run(const float* q, const float* k, const float* v,
                         Cand cand, const float* o, const float* lse,
                         const float* g, float* dq, float* dk, float* dv,
                         int B, int P, int H, int D, int h0, int w0, int h1,
                         int w1, float scale, cudaStream_t stream) {
    auto kernel = chunk_attention_bwd_kernel<Cand, kCopy16, kVecD, kSlots>;
    const int NC = cand.count(), parts = Cand::kPerHead ? H : 1;
    auto bytes = [=](int ch) { return bwd_smem_bytes(H, D, ch, NC, parts); };
    const int CH = fit_chunk(H, bytes);
    if (CH == 0) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(kernel, bytes(CH));
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)B * P;
    if (blocks == 0) return cudaSuccess;
    kernel<<<(unsigned)blocks, kThreads, bytes(CH), stream>>>(
        q, k, v, cand, o, lse, g, dq, dk, dv, P, H, D, h0, w0, h1, w1, CH,
        scale);
    return cudaGetLastError();
  }
};

}  // namespace casmtr
