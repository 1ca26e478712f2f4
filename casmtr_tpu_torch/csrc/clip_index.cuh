// The index rule of the JAX oracles' clipped gathers
// (take_along_axis(..., mode="clip")), shared by the three kernels and by
// kernels.clip_index on the Python side: a negative flat index counts once
// from the end, then the result is clamped into [0, n - 1].
#pragma once

namespace casmtr {

__device__ __forceinline__ long long clip_index(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

}  // namespace casmtr
