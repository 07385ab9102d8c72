// Per-row bodies of the blocked ELL kernels, at every payload type and
// accumulator of num.cuh.
//
// A column panel X (nbc, bc, k) is read with row stride ld: the caller
// points x at the first column it wants and passes ld = k, so entry b of
// column j of an x block sits at b * ld + j (ld = 1 for a vector).
//
// ell_row_lanes + lanes_sum (a sub-warp per row) are the row body of
// block_spmv, block_spmm and fused_smoother: all three run them, so at the
// same lanes column j of a block_spmm result is bitwise block_spmv of
// column j, and the smoother's A x is bitwise block_spmv's.
#pragma once

#include "common.cuh"
#include "num.cuh"

namespace repro {

// Lanes per row: a power of two that divides the warp.
inline bool lanes_ok(int lanes) {
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
}

// Payloads of even-width blocks are read in pairs (16 bytes at f64, 8 at
// f32, 4 at bf16), so they must start aligned to the pair.
template <int BC, typename T>
inline bool payload_ok(const void* data) {
  return BC % 2 != 0 || pair_aligned<T>(data);
}

// One block row of a payload block: BC elements widened to registers,
// read as pairs when BC is even (the caller guarantees pair-aligned
// payloads then).
template <int BC, typename T>
__device__ __forceinline__ void load_block_row(
    const T* __restrict__ p, typename Elem<T>::W (&w)[BC]) {
  if constexpr (BC % 2 == 0) {
    using P = typename Elem<T>::P;
    const P* q = reinterpret_cast<const P*>(p);
#pragma unroll
    for (int b = 0; b < BC / 2; ++b) {
      const P v = q[b];
      w[2 * b] = widen(v.x);
      w[2 * b + 1] = widen(v.y);
    }
  } else {
#pragma unroll
    for (int b = 0; b < BC; ++b) w[b] = widen(p[b]);
  }
}

// One slot of a row: acc[a][j] += blk[a][b] * x[b][j] as FMAs at the
// accumulator (Num<Acc>), over a, then b, then j, for the first ncol of
// KC columns of the slot's x block xb (row stride ld; the other columns
// of acc take exact zeros).  ell_row_lanes and fused_smoother's staged
// body both run it, so each (a, j) sees the same chain of FMAs in either.
template <int BR, int BC, int KC, typename T, typename Acc>
__device__ __forceinline__ void ell_slot(
    const T* __restrict__ blk, const T* __restrict__ xb, int ld, int ncol,
    typename Num<Acc>::R (&acc)[BR][KC]) {
  using N = Num<Acc>;
  using R = typename N::R;
  R xv[BC][KC];
#pragma unroll
  for (int b = 0; b < BC; ++b) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      xv[b][j] =
          j < ncol ? widen(xb[static_cast<long long>(b) * ld + j]) : R(0);
  }
#pragma unroll
  for (int a = 0; a < BR; ++a) {
    R w[BC];
    load_block_row<BC, T>(blk + a * BC, w);
#pragma unroll
    for (int b = 0; b < BC; ++b) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        acc[a][j] = N::fma(w[b], xv[b][j], acc[a][j]);
    }
  }
}

// One lane's share of a block row owned by a sub-warp of `lanes` lanes
// (aligned within the warp): the slots s = lane, lane + lanes, ... below
// kmax, ascending, each through ell_slot into acc (padded slots are zero
// blocks at column 0 and add exact zeros); acc starts at 0.  The chain of
// one (a, j) does not depend on KC, so a panel column runs the vector's
// chain.  Neighbouring lanes read neighbouring slots, so a sub-warp reads
// lanes * br * bc consecutive elements of the row per step.
template <int BR, int BC, int KC, typename T, typename Acc>
__device__ __forceinline__ void ell_row_lanes(
    const int* __restrict__ ri, const T* __restrict__ rd,
    const T* __restrict__ x, int ld, int ncol, int kmax, int lane,
    int lanes, typename Num<Acc>::R (&acc)[BR][KC]) {
  using R = typename Num<Acc>::R;
#pragma unroll
  for (int a = 0; a < BR; ++a) {
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[a][j] = R(0);
  }
  for (int s = lane; s < kmax; s += lanes)
    ell_slot<BR, BC, KC, T, Acc>(
        rd + static_cast<long long>(s) * BR * BC,
        x + static_cast<long long>(ri[s]) * BC * ld, ld, ncol, acc);
}

// The sub-warp's partials combined by a fixed xor butterfly (offsets
// lanes/2, ..., 1), every add rounded on its own at the accumulator's
// register type (__dadd_rn / __fadd_rn: nothing can be contracted into an
// FMA).  IEEE addition commutes, so every lane ends with the same sum.
// Every lane of the warp must call it.
template <int BR, int KC, typename Acc>
__device__ __forceinline__ void lanes_sum(typename Num<Acc>::R (&acc)[BR][KC],
                                          int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < BR; ++a) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        acc[a][j] = Num<Acc>::cadd(
            acc[a][j], __shfl_xor_sync(0xffffffffu, acc[a][j], o));
    }
  }
}

}  // namespace repro
