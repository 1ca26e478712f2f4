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
// bound it (18 us).  A design that reads each parent's patch cannot reach
// that: a patch is 100 rows of 512 bytes, so 554 MB cross from the
// L2 (which holds the overlapping patches of neighbouring parents) to the
// SMs, and that L2-to-SM traffic is the floor of this design.
//
// Design (window_score.cuh): one block of 128 threads per (b, p).  The four
// query rows are staged once; the patch streams through a ring in chunks
// of 32 candidates by 32 columns (128 floats when C % 4 == 0) by 16-byte
// cp.async, the next chunk in flight while the current one computes (for
// rows of at most 16 columns, chunks of 16 columns three stages deep, with
// more blocks per SM).  In a chunk, thread (quad, slice) takes the 4
// candidates of one quad and the columns slice, slice + 16: a register tile
// of 4 children x 4 candidates fed by 16-byte shared loads of the patch
// (the query columns stay in registers while the channel block does not
// change), 16 FMAs per shared load.  A quad's 16 slices are neighbouring
// lanes; after a candidate block's last channel block they add their tiles
// by a reduce-scatter of 15 shuffles, which leaves each lane one of the 16
// sums, and write them in candidate order (four 32-byte runs per warp).
// Any w up to 64 and any C: 4-byte copies when C % 4 != 0 or an input is
// not 16-byte aligned, float columns when C % 4 != 0.  The last chunk of
// w = 5 (100 = 3 x 32 + 4 candidates) keeps one quad of eight busy.

#include <cuda_runtime.h>

#include "window_score.cuh"

namespace casmtr {

// Lanes s and s ^ H (H = 8, 4, 2, 1 in turn) swap halves of their values
// and add: afterwards lane s of a group of 16 holds the group's sum of
// value s in v[0].
template <int H>
__device__ __forceinline__ void reduce_scatter(float (&v)[16], int s) {
  const bool hi = (s & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = hi ? v[i] : v[i + H];
    const float keep = hi ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
  if constexpr (H > 1) reduce_scatter<H / 2>(v, s);
}

// A chunk's shape: kCols columns (of 4 floats, or 1) in a ring of kStages.
// Wide: 32 columns, two stages, the query columns in registers, at most 85
// registers (6 blocks per SM).  Narrow, for rows of at most 16 columns
// (C <= 64 floats, or 16): 16 columns, three stages, at most 64 registers
// (8 blocks per SM), so more chunks are in flight where each is small.
template <int kCols, int kStagesT>
struct ScoreTile {
  static constexpr int kColumns = kCols;
  static constexpr int kRing = kStagesT;
  static constexpr int kMinBlocks = kCols == kScoreNarrowCols ? 8 : 6;
};
using WideTile = ScoreTile<kScoreCols, kStages>;
using NarrowTile = ScoreTile<kScoreNarrowCols, 3>;

template <bool kCopy16, bool kVec, typename Tile>
__global__ void __launch_bounds__(kThreads, Tile::kMinBlocks)
window_score_kernel(const float* __restrict__ q,
                    const float* __restrict__ feat1,
                    const int* __restrict__ corners, float* __restrict__ out,
                    int P, int C, int H1, int W1, int w) {
  constexpr int W = kVec ? 4 : 1;           // floats per column
  constexpr int CH = kScoreChunk;
  constexpr int kRing = Tile::kRing;
  constexpr int kColsPerSlice = Tile::kColumns / kScoreSlices;
  extern __shared__ __align__(16) float smem[];
  const int NC = 4 * w * w;
  const int KC = Tile::kColumns * W;        // floats per channel block
  const int S = score_stride<kVec>(min(KC, C));
  const int QS = (C + 3) & ~3;
  float* qs = smem;                               // [4][QS]
  float* ring = qs + 4 * QS;                      // [kRing][CH][S]
  int* pos = reinterpret_cast<int*>(ring + kRing * CH * S);   // [NC]
  const long long bp = blockIdx.x;
  const int b = (int)(bp / P);
  const int tid = threadIdx.x;
  const long long n_pos = (long long)H1 * W1;
  const float* f1 = feat1 + (size_t)b * n_pos * C;

  patch_positions(corners, bp, w, W1, n_pos, pos, nullptr);
  __syncthreads();
  // the query rows join chunk 0's copy group
  copy_rows<kCopy16>(qs, QS, q + bp * 4 * C, 4, C,
                     [=](int f) { return (size_t)f * C; });
  const int n_kb = (C + KC - 1) / KC, n_cb = (NC + CH - 1) / CH;
  const int n_chunks = n_kb * n_cb;
  auto issue = [&](int n) {   // chunk n = (candidate block, channel block)
    if (n < n_chunks) {
      const int cb = n / n_kb, c0 = cb * CH, k0 = (n - cb * n_kb) * KC;
      copy_rows<kCopy16>(ring + (n % kRing) * CH * S, S, f1 + k0,
                         min(CH, NC - c0), min(KC, C - k0),
                         [=](int r) { return (size_t)pos[c0 + r] * C; });
    }
    cp_async_commit();
  };

  const int quad = tid / kScoreSlices, s = tid % kScoreSlices;
  float acc[16];     // [child f][candidate r of the quad]
  float qv[kColsPerSlice][4][W];   // the query columns of a channel block
#pragma unroll
  for (int n = 0; n < kRing - 1; ++n) issue(n);
  for (int n = 0; n < n_chunks; ++n) {
    issue(n + kRing - 1);
    cp_async_wait<kRing - 1>();
    __syncthreads();
    const int cb = n / n_kb, kb = n - cb * n_kb;
    const int c0 = cb * CH, k0 = kb * KC;
    const int cnt = min(CH, NC - c0), n_cols = min(KC, C - k0) / W;
    if (kb == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    }
    if (n_kb > 1 || n == 0) {
#pragma unroll
      for (int k = 0; k < kColsPerSlice; ++k) {
        const int col = s + k * kScoreSlices;
        if (col < n_cols) {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            load_cols<W>(qv[k][f], qs + f * QS + k0 + col * W);
        }
      }
    }
    if (quad * 4 < cnt) {
      const float* st = ring + (n % kRing) * CH * S + quad * 4 * S;
#pragma unroll
      for (int k = 0; k < kColsPerSlice; ++k) {
        const int col = s + k * kScoreSlices;
        if (col < n_cols) {
          float pv[4][W];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            load_cols<W>(pv[r], st + r * S + col * W);
#pragma unroll
          for (int f = 0; f < 4; ++f)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int e = 0; e < W; ++e)
                acc[f * 4 + r] = fmaf(qv[k][f][e], pv[r][e], acc[f * 4 + r]);
        }
      }
    }
    if (kb == n_kb - 1) {   // every lane takes part in the shuffles
      reduce_scatter<8>(acc, s);
      const int c = c0 + quad * 4 + (s & 3);
      if (c < NC) out[(bp * 4 + (s >> 2)) * NC + c] = acc[0];
    }
    __syncthreads();
  }
}

// Shared memory of one block.
template <typename Tile>
inline size_t score_smem_bytes(int C, int w, bool vec) {
  const int KC = Tile::kColumns * (vec ? 4 : 1);
  const int kc = C < KC ? C : KC;
  const int S = vec ? score_stride<true>(kc) : score_stride<false>(kc);
  return (size_t)(4 * ((C + 3) & ~3) + Tile::kRing * kScoreChunk * S) *
             sizeof(float) +
         (size_t)4 * w * w * sizeof(int);
}

template <bool kCopy16, bool kVec, typename Tile>
cudaError_t launch_score(const float* q, const float* feat1,
                         const int* corners, float* out, int B, int P, int C,
                         int H1, int W1, int w, cudaStream_t stream) {
  auto kernel = window_score_kernel<kCopy16, kVec, Tile>;
  const size_t bytes = score_smem_bytes<Tile>(C, w, kVec);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * P;
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(q, feat1, corners,
                                                         out, P, C, H1, W1,
                                                         w);
  return cudaGetLastError();
}

// The narrow tile for rows of at most kScoreNarrowCols columns, else the
// wide one.
struct LaunchScore {
  template <bool kCopy16, bool kVec, typename... Args>
  static cudaError_t run(const float* q, const float* feat1,
                         const int* corners, float* out, int B, int P, int C,
                         Args... args) {
    if (C <= kScoreNarrowCols * (kVec ? 4 : 1))
      return launch_score<kCopy16, kVec, NarrowTile>(q, feat1, corners, out,
                                                     B, P, C, args...);
    return launch_score<kCopy16, kVec, WideTile>(q, feat1, corners, out, B,
                                                 P, C, args...);
  }
};

}  // namespace casmtr

// q_blk [B, P, 4, C], feat1 [B, H1*W1, C], corners [B, P, 2] int32 (y, x) on
// the half grid, out [B, P, 4, 4w^2]; all f32 contiguous on one device.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue when w is
// outside 1..kMaxWindow or the block's shared memory exceeds 227 KB).
extern "C" int casmtr_window_patch_score_f32(const float* q, const float* feat1,
                                             const int* corners, float* out,
                                             int B, int P, int C, int H1,
                                             int W1, int w, void* stream) {
  using namespace casmtr;
  if (w < 1 || w > kMaxWindow || C < 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch_copy<LaunchScore, true>(
      C % 4 == 0 && aligned16(q, feat1), C % 4 == 0, q, feat1, corners, out,
      B, P, C, H1, W1, w, static_cast<cudaStream_t>(stream));
}
