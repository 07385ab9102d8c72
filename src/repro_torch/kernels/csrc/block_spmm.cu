// block_spmm — Y = A X over padded BlockELL with a column panel X, on
// Hopper: (nbr, kmax) int32 indices, (nbr, kmax, br, bc) data,
// (nbc, bc, k) X -> (nbr, br, k) Y.
//
// Replaces the TPU kernel repro/kernels/block_spmm/block_spmm.py
// (block_spmm_ell / _spmm_kernel).  The TPU wrapper pads k to a lane
// multiple; here k is a runtime argument and nothing is padded.
//
// Bound: bytes.  The operator stream (valid blocks and their int32
// indices) is the same as block_spmv's and is now shared by k columns; X
// is read and Y written once.  Design (first, plain): one thread per
// (block row, column), consecutive threads on consecutive columns of one
// row, so the (nbc, bc, k) panel gathers of a warp are coalesced and each
// A block is read once per row by the warp and broadcast to its columns.
// Every thread runs ell_row_apply, the body block_spmv runs, with column
// stride k: column j of Y is bitwise block_spmv of column j of X.
#include "ell_row.cuh"

namespace {

template <int BR, int BC>
__global__ void spmm_kernel(const int* __restrict__ idx,
                            const double* __restrict__ data,
                            const double* __restrict__ x,
                            double* __restrict__ y, int nbr, int kmax,
                            int k) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nbr) * k) return;
  const long long r = t / k;
  const int j = static_cast<int>(t % k);
  double acc[BR];
  repro::ell_row_apply<BR, BC>(idx + r * kmax, data + r * kmax * BR * BC,
                               x + j, k, kmax, acc);
  double* yr = y + r * BR * k + j;
#pragma unroll
  for (int a = 0; a < BR; ++a) yr[static_cast<long long>(a) * k] = acc[a];
}

template <int BR, int BC>
int launch(const int* idx, const double* data, const double* x, double* y,
           int nbr, int kmax, int k, int threads, cudaStream_t stream) {
  const long long n = static_cast<long long>(nbr) * k;
  if (n == 0) return repro::last_error();
  spmm_kernel<BR, BC><<<repro::blocks_for(n, threads), threads, 0,
                        stream>>>(idx, data, x, y, nbr, kmax, k);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_block_spmm_f64(const void* indices, const void* data,
                                   const void* x, void* y, int nbr, int kmax,
                                   int br, int bc, int k, int threads,
                                   void* stream) {
  auto i = static_cast<const int*>(indices);
  auto d = static_cast<const double*>(data);
  auto xv = static_cast<const double*>(x);
  auto yv = static_cast<double*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads;
  if (k <= 0 || !repro::threads_ok(t)) return repro::bad_shape();
  if (br == 3 && bc == 3)
    return launch<3, 3>(i, d, xv, yv, nbr, kmax, k, t, s);
  if (br == 3 && bc == 6)
    return launch<3, 6>(i, d, xv, yv, nbr, kmax, k, t, s);
  if (br == 6 && bc == 6)
    return launch<6, 6>(i, d, xv, yv, nbr, kmax, k, t, s);
  return repro::bad_shape();
}
