// Shared helpers of the repro_torch kernel library (plain C interface,
// loaded with ctypes).  Every entry point launches on the stream it is
// given, allocates nothing and returns cudaGetLastError() (0 = launched).
#pragma once

#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

// Threads per block of the kernels the autotuner does not tune
// (block_seg_sum, block_pair_gemm), and the tuned kernels' default.
constexpr int kThreads = 256;

// The tuned kernels take their block size from the caller (the
// autotuner's `threads` knob): whole warps, at most the card's 1024.
inline bool threads_ok(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

inline unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

inline int bad_shape() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace repro
