// Per-row bodies of the blocked ELL kernels.
//
// A column panel X (nbc, bc, k) is read with row stride ld: the caller
// points x at the first column it wants and passes ld = k, so entry b of
// column j of an x block sits at b * ld + j (ld = 1 for a vector).
//
// ell_row_apply (one thread per row) is fused_smoother's body.
// ell_row_lanes + lanes_sum (a sub-warp per row) are block_spmv's and
// block_spmm's: both kernels run them, so column j of a block_spmm result
// is bitwise block_spmv of column j.
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

// Lanes per row: a power of two that divides the warp.
inline bool lanes_ok(int lanes) {
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
}

// Payloads of even-width blocks are read in 16-byte pairs.
template <int BC>
inline bool payload_ok(const void* data) {
  return BC % 2 != 0 || reinterpret_cast<unsigned long long>(data) % 16 == 0;
}

// One block row of a payload block: BC doubles, read as 16-byte pairs
// when BC is even (the caller guarantees 16-byte aligned payloads then).
template <int BC>
__device__ __forceinline__ void load_block_row(const double* __restrict__ p,
                                               double (&w)[BC]) {
  if constexpr (BC % 2 == 0) {
    const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int b = 0; b < BC / 2; ++b) {
      const double2 v = q[b];
      w[2 * b] = v.x;
      w[2 * b + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int b = 0; b < BC; ++b) w[b] = p[b];
  }
}

// One lane's share of a block row owned by a sub-warp of `lanes` lanes
// (aligned within the warp): the slots s = lane, lane + lanes, ... below
// kmax, ascending.  acc[a][j] = sum over those slots, then over b, of
// blk[s][a][b] * x[col(s)][b][j], as FMAs in that order, for the first
// ncol of KC columns (the rest stay 0): ell_row_apply's chain on the
// lane's slots.  The chain of one (a, j) does not depend on KC, so a
// panel column runs the vector's chain.  Neighbouring lanes read
// neighbouring slots, so a sub-warp reads lanes * br * bc consecutive
// doubles of the row per step.
template <int BR, int BC, int KC>
__device__ __forceinline__ void ell_row_lanes(const int* __restrict__ ri,
                                              const double* __restrict__ rd,
                                              const double* __restrict__ x,
                                              int ld, int ncol, int kmax,
                                              int lane, int lanes,
                                              double (&acc)[BR][KC]) {
#pragma unroll
  for (int a = 0; a < BR; ++a) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[a][j] = 0.0;
  }
  for (int s = lane; s < kmax; s += lanes) {
    const double* xb = x + static_cast<long long>(ri[s]) * BC * ld;
    double xv[BC][KC];
#pragma unroll
    for (int b = 0; b < BC; ++b) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        xv[b][j] = j < ncol ? xb[static_cast<long long>(b) * ld + j] : 0.0;
    }
    const double* blk = rd + static_cast<long long>(s) * BR * BC;
#pragma unroll
    for (int a = 0; a < BR; ++a) {
      double w[BC];
      load_block_row<BC>(blk + a * BC, w);
#pragma unroll
      for (int b = 0; b < BC; ++b) {
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[a][j] = fma(w[b], xv[b][j], acc[a][j]);
      }
    }
  }
}

// The sub-warp's partials combined by a fixed xor butterfly (offsets
// lanes/2, ..., 1), every add rounded on its own (__dadd_rn: nothing can
// be contracted into an FMA).  IEEE addition commutes, so every lane ends
// with the same sum.  Every lane of the warp must call it.
template <int BR, int KC>
__device__ __forceinline__ void lanes_sum(double (&acc)[BR][KC], int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < BR; ++a) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        acc[a][j] = __dadd_rn(acc[a][j],
                              __shfl_xor_sync(0xffffffffu, acc[a][j], o));
    }
  }
}

}  // namespace repro
