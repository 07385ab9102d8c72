// fused_pair_gemm — the Galerkin numeric product over the tiled
// (ELL-of-pairs) SpGEMM plan, on Hopper:
//   out[row] = sum over valid slots k of A[ta[row,k]] @ B[tb[row,k]].
//
// Replaces the TPU kernel repro/kernels/fused_pair_gemm/fused_pair_gemm.py
// (fused_pair_gemm / _fused_kernel).  As there, the (npairs, br, bc)
// pair-product array is never built; unlike the TPU path, the A and B
// blocks are gathered inside the kernel through the plan's tile_pair_a/b
// and tile_mask, so the gathered operand arrays of the reference's
// _fused_numeric are never built either.  The output is one partial block
// per tile row; rows of one output slot (tile_identity False) are combined
// by block_seg_sum.
//
// Bound: bytes — each valid pair's A block and B block are read (gathers;
// B blocks repeat across a row's pairs and hit L2), plus the int32 plan
// and the mask, and one output block per tile row.  2*br*bk*bc flops per
// pair stay far below the fp64 balance.  Design (first, plain): one thread
// per (tile row, output element i, l) accumulates its row's pairs and the
// bk contraction in a register, in slot order then contraction order (the
// TPU kernel's order).  Masked (padded) slots are skipped.
#include "common.cuh"

namespace {

template <int BR, int BK, int BC>
__global__ void pair_gemm_kernel(const double* __restrict__ a,
                                 const double* __restrict__ b,
                                 const int* __restrict__ ta,
                                 const int* __restrict__ tb,
                                 const unsigned char* __restrict__ mask,
                                 double* __restrict__ out, int rows,
                                 int kmax) {
  constexpr int AREA = BR * BC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(rows) * AREA) return;
  const long long row = t / AREA;
  const int e = static_cast<int>(t % AREA);
  const int i = e / BC;
  const int l = e % BC;
  const long long base = row * kmax;
  double acc = 0.0;
  for (int k = 0; k < kmax; ++k) {
    if (!mask[base + k]) continue;
    const double* ab = a + static_cast<long long>(ta[base + k]) * BR * BK +
                       i * BK;
    const double* bb = b + static_cast<long long>(tb[base + k]) * BK * BC +
                       l;
#pragma unroll
    for (int j = 0; j < BK; ++j) acc = fma(ab[j], bb[j * BC], acc);
  }
  out[t] = acc;
}

template <int BR, int BK, int BC>
int launch(const double* a, const double* b, const int* ta, const int* tb,
           const unsigned char* mask, double* out, int rows, int kmax,
           int threads, cudaStream_t stream) {
  const long long n = static_cast<long long>(rows) * BR * BC;
  if (n == 0) return repro::last_error();
  pair_gemm_kernel<BR, BK, BC><<<repro::blocks_for(n, threads), threads, 0,
                                 stream>>>(a, b, ta, tb, mask, out, rows,
                                           kmax);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_fused_pair_gemm_f64(const void* a, const void* b,
                                        const void* tile_a,
                                        const void* tile_b,
                                        const void* tile_mask, void* out,
                                        int rows, int kmax, int br, int bk,
                                        int bc, int threads,
                                        void* stream) {
  auto av = static_cast<const double*>(a);
  auto bv = static_cast<const double*>(b);
  auto ta = static_cast<const int*>(tile_a);
  auto tb = static_cast<const int*>(tile_b);
  auto m = static_cast<const unsigned char*>(tile_mask);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads;
  if (!repro::threads_ok(t)) return repro::bad_shape();
  if (br == 3 && bk == 3 && bc == 6)
    return launch<3, 3, 6>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 6 && bk == 3 && bc == 6)
    return launch<6, 3, 6>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 6 && bk == 6 && bc == 6)
    return launch<6, 6, 6>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  return repro::bad_shape();
}
