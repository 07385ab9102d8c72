// fused_smoother — one fused Chebyshev / damped-Jacobi recurrence step,
// on Hopper:  d' = c1 d + c2 D^-1 (b - A x),  x' = x + d'.
//
// Replaces the TPU kernel repro/kernels/fused_smoother/fused_smoother.py
// (smoother_step_ell / _smoother_kernel).  As there, the residual r and
// z = D^-1 r live in registers and never reach device memory.
//
// Bound: bytes — A's ELL payload and indices dominate (read once), then
// dinv, b, d, x (the own row plus the gathered neighbours, mostly from
// L2), and x', d' written once.  Design (first, plain): one thread per
// block row, as block_spmv, plus the bs x bs dinv matvec and the
// recurrence in registers.  x' is written out of place: the TPU kernel
// updates x while reading all of it, which on a parallel grid would race
// with the gathers of other rows.  [c1, c2] arrive as a two-element device
// tensor derived from the device scalar lambda_max, so no smoother step
// waits on the host.
#include "common.cuh"

namespace {

template <int BS>
__global__ void smoother_kernel(const int* __restrict__ idx,
                                const double* __restrict__ data,
                                const double* __restrict__ dinv,
                                const double* __restrict__ b,
                                const double* __restrict__ x,
                                const double* __restrict__ d,
                                const double* __restrict__ coef,
                                double* __restrict__ x_out,
                                double* __restrict__ d_out, int nbr,
                                int kmax) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nbr) return;
  double ax[BS];
#pragma unroll
  for (int a = 0; a < BS; ++a) ax[a] = 0.0;
  const int* ri = idx + static_cast<long long>(r) * kmax;
  const double* rd = data + static_cast<long long>(r) * kmax * BS * BS;
  for (int k = 0; k < kmax; ++k) {
    const double* xb = x + static_cast<long long>(ri[k]) * BS;
    double xv[BS];
#pragma unroll
    for (int c = 0; c < BS; ++c) xv[c] = xb[c];
    const double* blk = rd + static_cast<long long>(k) * BS * BS;
#pragma unroll
    for (int a = 0; a < BS; ++a) {
#pragma unroll
      for (int c = 0; c < BS; ++c) ax[a] = fma(blk[a * BS + c], xv[c], ax[a]);
    }
  }
  const long long o = static_cast<long long>(r) * BS;
  double res[BS];
#pragma unroll
  for (int a = 0; a < BS; ++a) res[a] = b[o + a] - ax[a];
  const double* di = dinv + static_cast<long long>(r) * BS * BS;
  const double c1 = coef[0];
  const double c2 = coef[1];
#pragma unroll
  for (int a = 0; a < BS; ++a) {
    double z = 0.0;
#pragma unroll
    for (int c = 0; c < BS; ++c) z = fma(di[a * BS + c], res[c], z);
    const double dn = c1 * d[o + a] + c2 * z;
    d_out[o + a] = dn;
    x_out[o + a] = x[o + a] + dn;
  }
}

template <int BS>
int launch(const int* idx, const double* data, const double* dinv,
           const double* b, const double* x, const double* d,
           const double* coef, double* x_out, double* d_out, int nbr,
           int kmax, cudaStream_t stream) {
  if (nbr == 0) return repro::last_error();
  smoother_kernel<BS><<<repro::blocks_for(nbr), repro::kThreads, 0,
                        stream>>>(idx, data, dinv, b, x, d, coef, x_out,
                                  d_out, nbr, kmax);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_fused_smoother_f64(const void* indices, const void* data,
                                       const void* dinv, const void* b,
                                       const void* x, const void* d,
                                       const void* coef, void* x_out,
                                       void* d_out, int nbr, int kmax,
                                       int bs, void* stream) {
  auto i = static_cast<const int*>(indices);
  auto a = static_cast<const double*>(data);
  auto di = static_cast<const double*>(dinv);
  auto bv = static_cast<const double*>(b);
  auto xv = static_cast<const double*>(x);
  auto dv = static_cast<const double*>(d);
  auto cf = static_cast<const double*>(coef);
  auto xo = static_cast<double*>(x_out);
  auto dout = static_cast<double*>(d_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bs == 3)
    return launch<3>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, s);
  if (bs == 6)
    return launch<6>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, s);
  return repro::bad_shape();
}
