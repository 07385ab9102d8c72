// Shared helpers of the repro_torch kernel library (plain C interface,
// loaded with ctypes).  Every entry point launches on the stream it is
// given, allocates nothing and returns cudaGetLastError() (0 = launched).
#pragma once

#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

inline int bad_shape() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace repro
