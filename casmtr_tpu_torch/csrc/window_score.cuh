// The parent patch of the cascade window scores, shared by kernel B
// (window_score.cu) and its backward B-bwd (window_score_bwd.cu).
//
// One block of kThreads threads serves one (batch b, parent p).  Its 4w^2
// candidates are the (2w x 2w) patch of feat1 at corners[b, p] * 2, in the
// order c = (wy * w + wx) * 4 + (dr * 2 + dc); their flat positions sit in
// shared memory for the whole block.  The patch streams through shared
// memory in chunks of kScoreChunk candidate rows by kScoreCols columns (of
// 4 floats when C % 4 == 0, else of 1; kernel B takes kScoreNarrowCols for
// narrow rows), in a ring filled by cp.async (block_chunk.cuh), so any w
// and any C fit: w up to kMaxWindow (the positions, 4 bytes per candidate
// for B and 8 for B-bwd, stay in shared memory), C as far as the query
// rows [4][C] fit beside the ring.
#pragma once

#include <cuda_runtime.h>

#include "block_chunk.cuh"
#include "clip_index.cuh"

namespace casmtr {

constexpr int kScoreChunk = 32;    // candidate rows per chunk: 8 quads of 4
constexpr int kScoreSlices = 16;   // B: channel slices per quad
constexpr int kScoreCols = 32;     // columns per chunk (of 4 floats, or 1)
constexpr int kScoreNarrowCols = 16;   // B's chunk columns for rows of at
                                       // most 16 columns
constexpr int kMaxWindow = 64;     // 16384 candidates
static_assert(kScoreChunk / 4 * kScoreSlices == kThreads,
              "kernel B: one thread per (quad, slice) of a chunk");
static_assert(kScoreCols % kScoreSlices == 0 &&
                  kScoreNarrowCols % kScoreSlices == 0,
              "kernel B: the same columns per slice");

// Shared-memory stride of a chunk's rows of kc floats.  Float4 columns are
// read by 8 lanes at a time from one row, so those rows are unpadded;
// float columns are padded to 4 (mod 8) floats, so the rows 4 apart that
// the two half-warps of kernel B read fall in distinct banks.
template <bool kVec>
__host__ __device__ inline int score_stride(int kc) {
  return kVec ? kc : row_stride(kc);
}

// The parent's candidate positions: pos[c] under the clipped-gather rule
// and, when spos is given, spos[c] under the JAX scatter rule (a negative
// flat index counts once from the end, and one still outside [0, n_pos)
// is dropped: -1).
__device__ inline void patch_positions(const int* corners, long long bp,
                                       int w, int W1, long long n_pos,
                                       int* pos, int* spos) {
  const int NC = 4 * w * w;
  const int cy = corners[bp * 2], cx = corners[bp * 2 + 1];
  for (int c = threadIdx.x; c < NC; c += kThreads) {
    const int g = c >> 2, wy = g / w;
    const long long row = 2LL * cy + 2 * wy + ((c >> 1) & 1);
    const long long col = 2LL * cx + 2 * (g - wy * w) + (c & 1);
    long long flat = row * W1 + col;
    pos[c] = (int)clip_index(flat, n_pos);
    if (spos != nullptr) {
      if (flat < 0) flat += n_pos;
      spos[c] = (flat < 0 || flat >= n_pos) ? -1 : (int)flat;
    }
  }
}

// Start this thread's copies of n_rows rows of kc floats into dst (row
// stride S): row r from src + offset(r).  Neighbouring threads take
// neighbouring words of a row.
template <bool kCopy16, typename Offset>
__device__ inline void copy_rows(float* dst, int S, const float* src,
                                 int n_rows, int kc, Offset offset) {
  constexpr int kWord = kCopy16 ? 4 : 1;
  const int per_row = kc / kWord;
  if (kThreads % per_row == 0) {   // a fixed word of rows r0, r0 + step, ..
    const int j = (threadIdx.x % per_row) * kWord;
    const int step = kThreads / per_row;
    for (int r = threadIdx.x / per_row; r < n_rows; r += step)
      cp_async_word<kCopy16>(dst + r * S + j, src + offset(r) + j);
  } else {
    for (int i = threadIdx.x; i < n_rows * per_row; i += kThreads) {
      const int r = i / per_row, j = (i - r * per_row) * kWord;
      cp_async_word<kCopy16>(dst + r * S + j, src + offset(r) + j);
    }
  }
}

}  // namespace casmtr
