// block_spmv — y = A x over padded BlockELL, on Hopper.
//
// Replaces the TPU kernel repro/kernels/block_spmv/block_spmv.py
// (block_spmv_ell / _spmv_kernel), and in the port also carries the
// products the reference left to jnp spmv_ell: CG's A p, the V-cycle
// residual, prolongation and the lambda_max power iteration.
//
// Bound: bytes.  Every (br x bc) payload block and its int32 column index
// are read once (2*br*bc flops per block, far below the card's
// flop-per-byte balance); x blocks are gathered (mostly from L2) and y is
// written once.  Design (first, plain): one thread per block row loops over
// its kmax slots, gathers the bc-wide x block by the slot's index, and
// accumulates br outputs in registers with FMAs (ell_row_apply, shared
// with block_spmm and fused_smoother).  Padded slots are zero blocks
// pointing at column 0, so they add exact zeros and need no mask.
// Thread-per-row reads each row's payload with a stride of kmax*br*bc
// doubles between neighbouring threads, and wide, short coarse levels
// launch few threads: a later redesign maps a warp to a row.
#include "ell_row.cuh"

namespace {

template <int BR, int BC>
__global__ void spmv_kernel(const int* __restrict__ idx,
                            const double* __restrict__ data,
                            const double* __restrict__ x,
                            double* __restrict__ y, int nbr, int kmax) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nbr) return;
  double acc[BR];
  repro::ell_row_apply<BR, BC>(idx + static_cast<long long>(r) * kmax,
                               data + static_cast<long long>(r) * kmax * BR *
                                          BC,
                               x, 1, kmax, acc);
  double* yr = y + static_cast<long long>(r) * BR;
#pragma unroll
  for (int a = 0; a < BR; ++a) yr[a] = acc[a];
}

template <int BR, int BC>
int launch(const int* idx, const double* data, const double* x, double* y,
           int nbr, int kmax, int threads, cudaStream_t stream) {
  if (nbr == 0) return repro::last_error();
  spmv_kernel<BR, BC><<<repro::blocks_for(nbr, threads), threads, 0,
                        stream>>>(idx, data, x, y, nbr, kmax);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_block_spmv_f64(const void* indices, const void* data,
                                   const void* x, void* y, int nbr, int kmax,
                                   int br, int bc, int threads,
                                   void* stream) {
  auto i = static_cast<const int*>(indices);
  auto d = static_cast<const double*>(data);
  auto xv = static_cast<const double*>(x);
  auto yv = static_cast<double*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads;
  if (!repro::threads_ok(t)) return repro::bad_shape();
  if (br == 3 && bc == 3) return launch<3, 3>(i, d, xv, yv, nbr, kmax, t, s);
  if (br == 3 && bc == 6) return launch<3, 6>(i, d, xv, yv, nbr, kmax, t, s);
  if (br == 6 && bc == 6) return launch<6, 6>(i, d, xv, yv, nbr, kmax, t, s);
  return repro::bad_shape();
}
