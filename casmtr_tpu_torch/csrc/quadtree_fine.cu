// Quadtree fine-level attention for Hopper, f32: kernel A, and kernel A′,
// the same body with the next level's top-k selection fused in.
//
// Replaces: casmtr_tpu/ops/pallas/quadtree_kernels.py:_fwd_kernel, with
// n_topk = 0 (kernel A, reached through masked_fine_level -> _message ->
// _fwd_call) and with n_topk > 0 (kernel A′, pallas_call at :321, reached
// through masked_fine_level(..., topk > 0) -> _message_topk -> _fwd_call).
// Contract: the gather path of casmtr_tpu/ops/quadtree.py:_fine_level_b,
// ported as quadtree_fine_attention_plain and, with need_topk,
// quadtree_fine_topk_plain.
//
// What it computes: for every (batch b, parent block p, head h) the four
// 2x2 child queries of p attend, with one softmax over 4K candidates, to the
// four children of each of the K key blocks that the previous (2x coarser)
// level selected for (p, h).  Candidate c = kk * 4 + (dr * 2 + dc) is the
// key at row (blk / (w1/2)) * 2 + dr, column (blk % (w1/2)) * 2 + dc of the
// (h1, w1) key grid, blk = ids[b, p, kk, h] taken under the oracle's
// clipped-gather rule (clip_index.cuh).  Output msg[b, p, f, h, :].  Kernel
// A′ also writes, for each child row, its n_topk largest probabilities in
// descending order, each with the flat position of its key on the (h1, w1)
// grid, into score/idx [B, h0*w0, n_topk, H] at the child's query row (the
// un-blocked layout the next level reads).  Ties go to the lower candidate
// index c, the order of the gather path; a NaN ranks above every number, as
// in torch.topk, so a non-finite row selects in candidate order and passes
// its NaN on to the loss.
//
// What bounds it on an H100: at the finest 104x104 level of the 832^2 eval
// (q/k/v [1, 10816, 8, 32], K = 16) q, k, v and msg are ~11 MB each and the
// ids 1.4 MB, against ~0.7 GFLOP of f32 work outside the tensor cores, so
// device-memory bytes bound kernel A (0.0136 ms); at the intermediate 52x52
// level (K = 32, top 16) the bytes shrink 4x and the attention FMAs bound
// A′ (0.0053 ms).  In practice the pace is set by re-reading each
// (parent, head)'s candidate slices from the 50 MB L2 (neighbouring parents
// select overlapping key blocks): 64 K and 64 V slices of 128 B per
// (parent, head), 354 MB at 104^2, and by the f32 score and softmax work
// (PERF.md holds the measured times).
//
// Design (chunk_attention.cuh, candidates BlockChildren): the TPU kernel's
// child-major K/V, dense QK against every key with a membership bias, exp2
// pre-scaling and -1/-2 sentinels existed only because Mosaic has no cheap
// gather.  Here one block of 128 threads serves one (b, p), all heads: it
// expands the parent's K x H block ids into 4K key positions per head once,
// then streams each head's candidate slices (D floats at pos * H*D + h*D)
// through swizzled shared memory by cp.async, 16-byte words with 8 threads
// on a 128-byte slice, the next chunk in flight while one computes; scores,
// FlashAttention's online softmax and P.V read only shared memory, four
// children per thread.  Duplicate ids are counted as often as they appear,
// as in the oracle, so the TPU kernel's distinct-ids precondition does not
// exist here.  A′ keeps every raw score in shared memory; after the last
// chunk it forms the numerators exp(s - m_final) and runs n_topk rounds of
// a 4-lane-group arg-max per child row (select_topk), the block's 32 groups
// on 32 rows at a time.  Any H and D: H*D up to 2048 floats (512 when
// D % 4 != 0).

#include <cuda_runtime.h>

#include "chunk_attention.cuh"

namespace casmtr {

template <bool kTopk>
cudaError_t launch_quadtree_fine(const float* q, const float* k,
                                 const float* v, const int* ids, float* out,
                                 float* lse, TopkOut sel, int B, int P, int K,
                                 int H, int D, int h0, int w0, int h1, int w1,
                                 float scale, cudaStream_t stream) {
  const BlockChildren cand{ids, K, H, w1, (h1 / 2) * (w1 / 2)};
  // a 16-byte copy stays within one head's slice only when D % 4 == 0
  const bool vec = D % 4 == 0 && aligned16(out);
  return dispatch<LaunchFwd<BlockChildren, kTopk>, true>(
      vec && aligned16(q, k, v), vec, H * D, q, k, v, cand, out, lse, sel, B,
      P, H, D, h0, w0, h1, w1, scale, stream);
}

}  // namespace casmtr

// Kernel A.  q [B, h0*w0, H, D], k/v [B, h1*w1, H, D], ids [B, P, K, H]
// int32 with P = (h0/2)*(w0/2), out [B, P, 4, H, D], lse [B, P, 4, H] or
// null (written only when a gradient will be needed); all f32 contiguous on
// one device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int casmtr_quadtree_fine_attention_f32(
    const float* q, const float* k, const float* v, const int* ids, float* out,
    float* lse, int B, int P, int K, int H, int D, int h0, int w0, int h1,
    int w1, float scale, void* stream) {
  return (int)casmtr::launch_quadtree_fine<false>(
      q, k, v, ids, out, lse, casmtr::TopkOut{}, B, P, K, H, D, h0, w0, h1,
      w1, scale, static_cast<cudaStream_t>(stream));
}

// Kernel A′: as kernel A, and score [B, h0*w0, n_topk, H] f32 and idx
// [B, h0*w0, n_topk, H] int32, 1 <= n_topk <= 4K.
extern "C" int casmtr_quadtree_fine_topk_f32(
    const float* q, const float* k, const float* v, const int* ids, float* out,
    float* lse, float* score, int* idx, int B, int P, int K, int H, int D,
    int h0, int w0, int h1, int w1, int n_topk, float scale, void* stream) {
  if (n_topk < 1 || n_topk > 4 * K) return (int)cudaErrorInvalidValue;
  return (int)casmtr::launch_quadtree_fine<true>(
      q, k, v, ids, out, lse, casmtr::TopkOut{score, idx, n_topk}, B, P, K, H,
      D, h0, w0, h1, w1, scale, static_cast<cudaStream_t>(stream));
}
