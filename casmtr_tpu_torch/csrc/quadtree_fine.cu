// Quadtree fine-level attention (kernel A) for Hopper, f32.
//
// Replaces: casmtr_tpu/ops/pallas/quadtree_kernels.py:_fwd_kernel with
// n_topk = 0 (reached through masked_fine_level -> _message -> _fwd_call).
// Contract: the gather path of casmtr_tpu/ops/quadtree.py:_fine_level_b,
// ported as quadtree_fine_attention_plain.
//
// What it computes: for every (batch b, parent block p, head h) the four
// 2x2 child queries of p attend, with one softmax over 4K candidates, to the
// four children of each of the K key blocks that the previous (2x coarser)
// level selected for (p, h).  Candidate c = kk * 4 + (dr * 2 + dc) is the
// key at row (blk / (w1/2)) * 2 + dr, column (blk % (w1/2)) * 2 + dc of the
// (h1, w1) key grid, blk = ids[b, p, kk, h] taken under the oracle's
// clipped-gather rule (clip_index.cuh).  Output msg[b, p, f, h, :].
//
// What bounds it on an H100: at the finest 104x104 level of the 832^2 eval
// (q/k/v [1, 10816, 8, 32], K = 16) each of q, k, v and msg is ~11 MB and
// the ids 1.4 MB, against ~0.7 GFLOP of f32 work outside the tensor cores,
// so device-memory bytes bound it (PERF.md holds the numbers).  Candidate
// key rows overlap between neighbouring parents; k and v (22 MB) fit in the
// 50 MB L2, so re-reads mostly hit L2.
//
// Design: the TPU kernel's child-major K/V, dense QK against every key with
// a membership bias and exp2 pre-scaling existed only because Mosaic has no
// cheap gather.  Here the gather is an address computation, so each warp
// computes the oracle's form directly: it expands its K block ids into 4K
// key positions, scores the four child queries against those rows, takes
// the softmax and aggregates the value rows (child_attention.cuh).  Duplicate
// ids are counted as often as they appear, as in the oracle, so the TPU
// kernel's distinct-ids precondition does not exist here.  One warp per
// (b, p, h); 4 warps per block; scratch in dynamic shared memory.

#include <cuda_runtime.h>

#include "child_attention.cuh"
#include "clip_index.cuh"

namespace casmtr {

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
quadtree_fine_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ ids,
                     float* __restrict__ out,
                     float* __restrict__ lse, int B, int P, int K, int H,
                     int D, int h0, int w0, int h1, int w1, float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long task = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (long long)B * P * H) return;  // uniform across the warp
  const int h = (int)(task % H);
  const long long bp = task / H;
  const int p = (int)(bp % P);
  const int b = (int)(bp / P);
  const int NC = 4 * K;

  float* qs = smem + (size_t)warp * child_attention_scratch_floats(D, NC);
  float* s = qs + 4 * D;
  int* pos = reinterpret_cast<int*>(s + 4 * NC);

  const int wq2 = w0 / 2;
  const int pr = p / wq2, pc = p % wq2;
  int qrow[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) qrow[f] = (2 * pr + (f >> 1)) * w0 + 2 * pc + (f & 1);

  const int wk2 = w1 / 2;
  const int n_blk = (h1 / 2) * wk2;
  const int* id_ph = ids + (size_t)bp * K * H + h;  // ids[b, p, :, h]
  for (int c = lane; c < NC; c += kWarp) {
    const int blk = (int)clip_index(id_ph[(size_t)(c >> 2) * H], n_blk);
    const int j = c & 3;
    pos[c] = ((blk / wk2) * 2 + (j >> 1)) * w1 + (blk % wk2) * 2 + (j & 1);
  }
  __syncwarp();

  const size_t row_stride = (size_t)H * D;
  const size_t q_off = (size_t)b * h0 * w0 * row_stride + (size_t)h * D;
  const size_t k_off = (size_t)b * h1 * w1 * row_stride + (size_t)h * D;
  float* o = out + (size_t)bp * 4 * row_stride + (size_t)h * D;
  float* l = lse == nullptr ? nullptr : lse + (size_t)bp * 4 * H + h;
  child_attention(q + q_off, k + k_off, v + k_off, o, qrow, pos, NC,
                  (int)row_stride, D, scale, qs, s, l, H, lane);
}

}  // namespace casmtr

// q [B, h0*w0, H, D], k/v [B, h1*w1, H, D], ids [B, P, K, H] int32 with
// P = (h0/2)*(w0/2), out [B, P, 4, H, D], lse [B, P, 4, H] or null (written
// only when a gradient will be needed); all f32 contiguous on one device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int casmtr_quadtree_fine_attention_f32(
    const float* q, const float* k, const float* v, const int* ids, float* out,
    float* lse, int B, int P, int K, int H, int D, int h0, int w0, int h1,
    int w1, float scale, void* stream) {
  using namespace casmtr;
  size_t smem = 0;
  cudaError_t err =
      prepare_child_attention_launch(quadtree_fine_kernel, D, 4 * K, &smem);
  if (err != cudaSuccess) return (int)err;
  const long long tasks = (long long)B * P * H;
  const unsigned blocks =
      (unsigned)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (blocks == 0) return (int)cudaSuccess;
  quadtree_fine_kernel<<<blocks, kWarpsPerBlock * kWarp, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, k, v, ids, out, lse, B, P, K, H, D, h0, w0, h1, w1, scale);
  return (int)cudaGetLastError();
}
