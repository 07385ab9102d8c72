// Per-row bodies shared by block_spmv, block_spmm and fused_smoother.
//
// A column panel X (nbc, bc, k) is read one column at a time: the caller
// points x at column j and passes ld = k, so consecutive entries of one
// x block are ld doubles apart (ld = 1 for a vector).  Because the vector
// and the panel kernels run this one body, column j of a panel result is
// bitwise the vector result for column j.
#pragma once

#include "common.cuh"

namespace repro {

// acc[a] = sum over the row's kmax slots, then over b, of
// blk[slot][a][b] * x[col(slot)][b], as FMAs into acc[a] in that order.
// Padded slots are zero blocks at column 0 and add exact zeros.
template <int BR, int BC>
__device__ __forceinline__ void ell_row_apply(const int* __restrict__ ri,
                                              const double* __restrict__ rd,
                                              const double* __restrict__ x,
                                              int ld, int kmax,
                                              double (&acc)[BR]) {
#pragma unroll
  for (int a = 0; a < BR; ++a) acc[a] = 0.0;
  for (int s = 0; s < kmax; ++s) {
    const double* xb = x + static_cast<long long>(ri[s]) * BC * ld;
    double xv[BC];
#pragma unroll
    for (int b = 0; b < BC; ++b) xv[b] = xb[static_cast<long long>(b) * ld];
    const double* blk = rd + static_cast<long long>(s) * BR * BC;
#pragma unroll
    for (int a = 0; a < BR; ++a) {
#pragma unroll
      for (int b = 0; b < BC; ++b) acc[a] = fma(blk[a * BC + b], xv[b], acc[a]);
    }
  }
}

}  // namespace repro
