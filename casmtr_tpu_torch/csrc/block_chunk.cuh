// The block-per-parent layout of the chunked attention kernels A, A′,
// A-bwd (quadtree_fine*.cu) and C, C-bwd (window_attention*.cu), whose
// bodies are in chunk_attention.cuh; kernels B and B-bwd
// (window_score*.cu) use its copies, loads and dispatch_copy.
//
// One block of kThreads threads serves one (batch b, parent block p), all
// heads at once.  A query row is H*D contiguous elements, and so is a row of
// candidate keys (or values) in shared memory: its H head slices come from
// one key position (kernel C: one candidate set for all heads) or from one
// position per head (kernel A: each head has its own).  The elements are
// floats, or bf16 for the bf16-input instances (the T template
// parameter): K and V rows are then staged as bf16, as they lie in
// device memory, and turned into floats where they are read; all arithmetic
// is f32.  The block copies them with cp.async, neighbouring threads on
// neighbouring 16-byte words (4-byte words when a slice is not a whole
// number of 16-byte words or a pointer is not 16-byte aligned: the kCopy16
// template parameter), so each 128-byte head slice is 8 threads' copy.  K
// and V rows whose width is a multiple of 128 bytes are kept unpadded in
// shared memory with their 16-byte words XOR-swizzled by row (kv_col), so
// threads reading the same column of 8 consecutive rows, or 8 neighbouring
// words of one row, hit distinct banks; other widths are padded
// (row_stride).
//
// The candidates stream through shared memory in chunks of chunk_rows(H)
// rows of K and of V, in a ring of kStages stages: the next chunk's copies
// are in flight while the current one computes.
//
// Work split inside a chunk:
// - scores: threads over (child pair, head, candidate); the CH candidates of
//   one (child pair, head) are CH neighbouring lanes of one warp (CH divides
//   32), so a softmax row's max and sum over the chunk are warp shuffles;
// - products with the value (or key) rows: threads over (candidate group,
//   4 floats of the row), each for all 4 children, so every shared row is
//   read once per chunk and the 4 children's probabilities arrive as one
//   16-byte load ([head][candidate][child] layout); the sums stay in
//   registers across chunks, and the candidate groups' partial sums are
//   added once at the end.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include <type_traits>

#include "clip_index.cuh"

namespace casmtr {

constexpr int kThreads = 128;      // 4 warps per block
constexpr int kWarp = 32;
constexpr int kChunkPairs = 64;    // (head, candidate) pairs per chunk
constexpr int kStages = 2;         // chunks of K and V rows in shared memory
constexpr int kMaxSlots = 4;       // row columns per thread: H*D <= 2048
                                   // (columns of 4 elements) or 512 (of 1)
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Candidates per chunk for H heads: kChunkPairs / H rounded down to a power
// of two, at most 32 (a softmax row's candidates share a warp), at least 1.
// The launchers halve it further only when the chunk's rows would not fit
// in shared memory.
__host__ __device__ inline int chunk_rows(int H) {
  int c = kChunkPairs / H;
  c = c > 32 ? 32 : (c < 1 ? 1 : c);
  while (c & (c - 1)) c &= c - 1;
  return c;
}

// Candidate groups of the product passes for rows of n_cols columns (of
// 4 floats, or of 1): as many as fill the block, at most one per candidate.
__host__ __device__ inline int candidate_groups(int CH, int n_cols) {
  const int g = kThreads / n_cols;
  return g < 1 ? 1 : (g > CH ? CH : g);
}

// Elements of type T in a 16-byte word: 4 floats, 8 bf16; and its log2.
template <typename T>
__host__ __device__ constexpr int word_elems() {
  return 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int word_shift() {
  return sizeof(T) == 4 ? 2 : 3;
}

// Shared-memory stride, in elements, of a row of H*D elements: rounded up
// to a 16-byte word, plus one word.  Rows stay 16-byte aligned, and
// consecutive rows start 4 banks apart, so 8 threads reading 16 bytes each
// from 8 consecutive rows (one phase of a 16-byte shared load) touch 32
// distinct banks.
template <typename T = float>
__host__ __device__ inline int row_stride(int HD) {
  constexpr int E = word_elems<T>();
  return (HD + E - 1) / E * E + E;
}

// K and V rows of H*D elements are swizzled when a row is a multiple of 128
// bytes (8 words of 16 bytes: H*D % 32 == 0 for floats, % 64 for bf16), and
// then unpadded.
template <typename T = float>
__host__ __device__ inline bool swizzled(int HD) {
  return (HD * (int)sizeof(T)) % 128 == 0;
}

template <typename T = float>
__host__ __device__ inline int kv_stride(int HD) {
  return swizzled<T>(HD) ? HD : row_stride<T>(HD);
}

// Offset of element j in a K/V row whose swizzle key is `key` (the row's
// index mod 8 for swizzled rows, 0 otherwise): its 16-byte word moves
// within its aligned group of 8.
template <typename T = float>
__device__ __forceinline__ int kv_col(int j, int key) {
  constexpr int L = word_shift<T>();
  return (((j >> L) ^ key) << L) | (j & ((1 << L) - 1));
}

__device__ __forceinline__ int kv_key(int r, bool swz) {
  return swz ? (r & 7) : 0;
}

// Stride of a head's [candidate][child] probabilities: 4 floats per
// candidate, plus 4, so the 16-byte loads of one candidate for several
// heads fall in distinct banks.
__host__ __device__ inline int prob_stride(int CH) { return 4 * CH + 4; }

// Whether every pointer is 16-byte (4-byte) aligned.
template <typename... Ptrs>
inline bool aligned16(const Ptrs*... p) {
  return (((reinterpret_cast<uintptr_t>(p) & 15) == 0) && ...);
}

template <typename... Ptrs>
inline bool aligned4(const Ptrs*... p) {
  return (((reinterpret_cast<uintptr_t>(p) & 3) == 0) && ...);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// One word of a row: 16 bytes (kCopy16) or 4.
template <bool kCopy16>
__device__ __forceinline__ void cp_async_word(void* dst, const void* src) {
  if constexpr (kCopy16)
    cp_async16(dst, src);
  else
    cp_async4(dst, src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// A float, or a bf16 value widened to one (exactly: its bits are the
// float's upper half).
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The two bf16 values packed in a 32-bit word, low half first.
__device__ __forceinline__ float bf16_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// W consecutive elements (W = 4 or 1; 16 or 8 bytes when W = 4) as an
// array of floats, and floats back.
template <int W, typename T>
__device__ __forceinline__ void load_cols(float (&x)[W], const T* p) {
  if constexpr (W == 4 && std::is_same<T, float>::value) {
    const float4 v = ld4(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (W == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
  } else {
    x[0] = to_float(*p);
  }
}

// One 16-byte word of a shared row (4 floats or 8 bf16) as floats.
template <typename T>
__device__ __forceinline__ void load_word(float (&x)[word_elems<T>()],
                                          const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    load_cols<4>(x, p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    x[0] = bf16_lo(u.x); x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y); x[3] = bf16_hi(u.y);
    x[4] = bf16_lo(u.z); x[5] = bf16_hi(u.z);
    x[6] = bf16_lo(u.w); x[7] = bf16_hi(u.w);
  }
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    st4(p, make_float4(x[0], x[1], x[2], x[3]));
  else
    *p = x[0];
}

// Dot products of D floats of two shared rows a0, a1 with the elements
// j0 .. j0 + D - 1 of the K/V row b (swizzle key `key`), added to s0 and
// s1; one 16-byte word of b at a time when kVecD (D a whole number of
// words), in four independent partial sums each.
template <bool kVecD, typename T>
__device__ __forceinline__ void dot2(const float* a0, const float* a1,
                                     const T* b, int j0, int key, int D,
                                     float& s0, float& s1) {
  if constexpr (kVecD) {
    constexpr int E = word_elems<T>();
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    for (int d = 0; d < D; d += E) {
      float y[E];
      load_word<T>(y, b + kv_col<T>(j0 + d, key));
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 u = ld4(a0 + d + e), t = ld4(a1 + d + e);
        x0.x = fmaf(u.x, y[e], x0.x);
        x0.y = fmaf(u.y, y[e + 1], x0.y);
        x0.z = fmaf(u.z, y[e + 2], x0.z);
        x0.w = fmaf(u.w, y[e + 3], x0.w);
        x1.x = fmaf(t.x, y[e], x1.x);
        x1.y = fmaf(t.y, y[e + 1], x1.y);
        x1.z = fmaf(t.z, y[e + 2], x1.z);
        x1.w = fmaf(t.w, y[e + 3], x1.w);
      }
    }
    s0 += (x0.x + x0.y) + (x0.z + x0.w);
    s1 += (x1.x + x1.y) + (x1.z + x1.w);
  } else {
    for (int d = 0; d < D; ++d) {
      const float y = to_float(b[kv_col<T>(j0 + d, key)]);
      s0 = fmaf(a0[d], y, s0);
      s1 = fmaf(a1[d], y, s1);
    }
  }
}

// Query token of child f (0..3, row-major in the 2x2 block) of parent p on
// an (h0, w0) grid.
__device__ __forceinline__ int query_row(int p, int w0, int f) {
  const int wq2 = w0 / 2, pr = p / wq2, pc = p - pr * wq2;
  return (2 * pr + (f >> 1)) * w0 + 2 * pc + (f & 1);
}

// A destination row in shared memory and its source row.
struct RowCopy {
  float* dst;
  const float* src;
};

// The stream of chunks of K and V rows into the ring `kv`
// ([kStages][K rows | V rows][CH][SK] elements of T, swizzled when swz),
// and of the block's fixed float rows (the query rows; for the backward
// also the cotangent rows), by cp.async copies of 16 bytes (kCopy16) or 4.
// Row r of chunk n is HD / slice slices of `slice` elements, slice s copied
// from key position pos[(n * CH + r) * (HD / slice) + s] (slice = HD: one
// position per row; slice = D: one per head).  Each chunk is one copy
// group; the fixed rows join chunk 0's.
template <bool kCopy16, typename T = float>
struct ChunkStream {
  // elements per copy
  static constexpr int kWord = (kCopy16 ? 16 : 4) / (int)sizeof(T);
  T* kv;
  const int* pos;
  const T* k;
  const T* v;
  int CH, NC, SK, HD, slice;
  bool swz;

  __device__ T* stage(int n) const {
    return kv + (size_t)(n % kStages) * 2 * CH * SK;
  }

  __device__ static void copy(T* dst, const T* src) {
    cp_async_word<kCopy16>(dst, src);
  }

  // Copy n_rows fixed rows, row(r) giving each's RowCopy (float rows).
  template <typename Row>
  __device__ void stage_rows(int n_rows, Row row) const {
    static_assert(std::is_same<T, float>::value, "fixed rows are floats");
    const int per_row = HD / kWord;
    for (int i = threadIdx.x; i < n_rows * per_row; i += kThreads) {
      const int r = i / per_row, j = (i - r * per_row) * kWord;
      const RowCopy c = row(r);
      copy(c.dst + j, c.src + j);
    }
  }

  // Start the copies of chunk n, when it exists, and commit them as one
  // group (an empty group past the last chunk).  The stage it overwrites
  // must be free: every thread has passed a __syncthreads since its last
  // read.
  __device__ void issue(int n) const {
    if (n * CH < NC) {
      const int cnt = min(CH, NC - n * CH);
      const int parts = HD / slice;
      const int* p = pos + (size_t)n * CH * parts;
      T* ks = stage(n);
      T* vs = ks + (size_t)CH * SK;
      const int per_row = HD / kWord;
      if (kThreads % per_row == 0) {   // a fixed word of rows r0, r0 + step..
        const int j = (threadIdx.x % per_row) * kWord, s = j / slice;
        const int step = kThreads / per_row;
        for (int r = threadIdx.x / per_row; r < cnt; r += step) {
          const int d = r * SK + kv_col<T>(j, kv_key(r, swz));
          const size_t src = (size_t)p[r * parts + s] * HD + j;
          copy(ks + d, k + src);
          copy(vs + d, v + src);
        }
      } else {
        for (int i = threadIdx.x; i < cnt * per_row; i += kThreads) {
          const int r = i / per_row, j = (i - r * per_row) * kWord;
          const int d = r * SK + kv_col<T>(j, kv_key(r, swz));
          const size_t src = (size_t)p[r * parts + j / slice] * HD + j;
          copy(ks + d, k + src);
          copy(vs + d, v + src);
        }
      }
    }
    cp_async_commit();
  }

  // Wait until the oldest chunk in flight (and, with chunk 0, the fixed
  // rows) has landed, visible to every thread of the block.
  __device__ void wait() const {
    cp_async_wait<kStages - 1>();
    __syncthreads();
  }
};

// Max and sum within aligned groups of G lanes (G a power of two <= 32);
// every lane of the warp must take part.
__device__ __forceinline__ float group_max(float x, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The columns this thread owns in the product passes: candidate group cg
// (of n_cg; the thread is idle when cg >= n_cg) and, per slot s, the
// first float of its column (-1 past the row) and that column's head.
template <int W, int kSlots>
struct Columns {
  int cg;
  int j[kSlots];
  int h[kSlots];
  __device__ __forceinline__ Columns(int HD, int D, int n_cg) {
    const int n_cols = HD / W;
    const int t = threadIdx.x;
    cg = n_cols <= kThreads ? t / n_cols : 0;
    const int first = n_cols <= kThreads ? t % n_cols : t;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int jc = first + s * kThreads;
      const bool ok = cg < n_cg && jc < n_cols;
      j[s] = ok ? jc * W : -1;
      h[s] = ok ? jc * W / D : 0;
    }
  }
};

// Raise the kernel's dynamic shared-memory limit when the default 48 KB is
// too small.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The chunk size for H heads whose shared memory, as `smem_bytes(CH)`
// gives it, fits in kMaxSmem; 0 when not even one row fits.
template <typename SmemBytes>
inline int fit_chunk(int H, SmemBytes smem_bytes) {
  int ch = chunk_rows(H);
  while (ch > 1 && smem_bytes(ch) > kMaxSmem) ch /= 2;
  return smem_bytes(ch) > kMaxSmem ? 0 : ch;
}

// Column slots per thread for rows of n_cols columns: 1, or kMaxSlots for
// rows wider than the block; 0 when even that is too few.
inline int column_slots(int n_cols) {
  if (n_cols <= kThreads) return 1;
  return n_cols <= kMaxSlots * kThreads ? kMaxSlots : 0;
}

// Launch::run<kCopy16, kVecD>(args...) for the instance that the rows
// allow: 16-byte copies when `copy16`, float4 columns when `vec`.  With
// kCopyNeedsVec (where a 16-byte copy needs the float4 columns' alignment)
// the callers never ask for 16-byte copies without float4 columns, and that
// instance is not built.
template <typename Launch, bool kCopyNeedsVec = false, typename... Args>
inline cudaError_t dispatch_copy(bool copy16, bool vec, Args... args) {
  auto run = [&](auto c16, auto v4) {
    return Launch::template run<decltype(c16)::value, decltype(v4)::value>(
        args...);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (copy16) {
    if (vec) return run(T{}, T{});
    if constexpr (kCopyNeedsVec)
      return cudaErrorInvalidValue;
    else
      return run(T{}, F{});
  }
  return vec ? run(F{}, T{}) : run(F{}, F{});
}

// Launch::run<kCopy16, kVecD, kSlots> seen as dispatch_copy's Launch.
template <typename Launch, int kSlots>
struct WithSlots {
  template <bool kCopy16, bool kVecD, typename... Args>
  static cudaError_t run(Args... args) {
    return Launch::template run<kCopy16, kVecD, kSlots>(args...);
  }
};

// Launch::run<kCopy16, kVecD, kSlots>(args...) for the instance that rows
// of HD elements allow: dispatch_copy's, with one column slot per thread or
// kMaxSlots (columns of 4 elements when vec).  For the quadtree's per-head
// slices (kCopyNeedsVec) a 16-byte copy needs a slice of whole 16-byte
// words, as the launchers' vec does (D % 4 == 0 for floats, % 8 for bf16).
template <typename Launch, bool kCopyNeedsVec = false, typename... Args>
inline cudaError_t dispatch(bool copy16, bool vec, int HD, Args... args) {
  const int slots = column_slots(vec ? HD / 4 : HD);
  if (slots == 0) return cudaErrorInvalidValue;
  return slots == 1
             ? dispatch_copy<WithSlots<Launch, 1>, kCopyNeedsVec>(
                   copy16, vec, args...)
             : dispatch_copy<WithSlots<Launch, kMaxSlots>, kCopyNeedsVec>(
                   copy16, vec, args...);
}

}  // namespace casmtr
