// fused_smoother — one fused Chebyshev / damped-Jacobi recurrence step,
// on Hopper:  d' = c1 d + c2 D^-1 (b - A x),  x' = x + d',
// over (nbr, bs) block vectors or (nbr, bs, k) column panels.
//
// Replaces the TPU kernel repro/kernels/fused_smoother/fused_smoother.py
// (smoother_step_ell / _smoother_kernel), both its vector and its panel
// form.  As there, the residual r and z = D^-1 r live in registers and
// never reach device memory.
//
// Bound: bytes — A's ELL payload and indices dominate (read once, and for
// a panel shared by its k columns), then dinv, b, d, x (the own row plus
// the gathered neighbours, mostly from L2), and x', d' written once.
// Design (first, plain): one thread per block row for a vector, one per
// (block row, column) for a panel with consecutive threads on consecutive
// columns (coalesced panel reads, A blocks broadcast within the warp).
// Both kernels run smoother_row: A x through ell_row_apply (the
// block_spmv body), then the bs x bs dinv matvec and the recurrence in
// registers, the recurrence with explicit roundings (__dmul_rn/__dadd_rn,
// never contracted to an FMA), so a panel column is bitwise the vector
// step.  x' is written out of place: the TPU kernel updates x while
// reading all of it, which on a parallel grid would race with the gathers
// of other rows.  [c1, c2] arrive as a two-element device tensor derived
// from the device scalar lambda_max, so no smoother step waits on the
// host; all columns share it.
#include "ell_row.cuh"

namespace {

// Row r of one column; b, x, d, x_out, d_out point at that column and
// entry (row, a) sits at (row * BS + a) * ld.
template <int BS>
__device__ __forceinline__ void smoother_row(
    const int* __restrict__ idx, const double* __restrict__ data,
    const double* __restrict__ dinv, const double* __restrict__ b,
    const double* __restrict__ x, const double* __restrict__ d,
    const double* __restrict__ coef, double* __restrict__ x_out,
    double* __restrict__ d_out, long long r, int kmax, int ld) {
  double ax[BS];
  repro::ell_row_apply<BS, BS>(idx + r * kmax, data + r * kmax * BS * BS, x,
                               ld, kmax, ax);
  const long long o = r * BS;
  double res[BS];
#pragma unroll
  for (int a = 0; a < BS; ++a) res[a] = b[(o + a) * ld] - ax[a];
  const double* di = dinv + r * BS * BS;
  const double c1 = coef[0];
  const double c2 = coef[1];
#pragma unroll
  for (int a = 0; a < BS; ++a) {
    double z = 0.0;
#pragma unroll
    for (int c = 0; c < BS; ++c) z = fma(di[a * BS + c], res[c], z);
    const long long e = (o + a) * ld;
    const double dn = __dadd_rn(__dmul_rn(c1, d[e]), __dmul_rn(c2, z));
    d_out[e] = dn;
    x_out[e] = __dadd_rn(x[e], dn);
  }
}

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
  smoother_row<BS>(idx, data, dinv, b, x, d, coef, x_out, d_out, r, kmax, 1);
}

template <int BS>
__global__ void smoother_panel_kernel(
    const int* __restrict__ idx, const double* __restrict__ data,
    const double* __restrict__ dinv, const double* __restrict__ b,
    const double* __restrict__ x, const double* __restrict__ d,
    const double* __restrict__ coef, double* __restrict__ x_out,
    double* __restrict__ d_out, int nbr, int kmax, int k) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nbr) * k) return;
  const long long r = t / k;
  const int j = static_cast<int>(t % k);
  smoother_row<BS>(idx, data, dinv, b + j, x + j, d + j, coef, x_out + j,
                   d_out + j, r, kmax, k);
}

template <int BS>
int launch(const int* idx, const double* data, const double* dinv,
           const double* b, const double* x, const double* d,
           const double* coef, double* x_out, double* d_out, int nbr,
           int kmax, int threads, cudaStream_t stream) {
  if (nbr == 0) return repro::last_error();
  smoother_kernel<BS><<<repro::blocks_for(nbr, threads), threads, 0,
                        stream>>>(idx, data, dinv, b, x, d, coef, x_out,
                                  d_out, nbr, kmax);
  return repro::last_error();
}

template <int BS>
int launch_panel(const int* idx, const double* data, const double* dinv,
                 const double* b, const double* x, const double* d,
                 const double* coef, double* x_out, double* d_out, int nbr,
                 int kmax, int k, int threads, cudaStream_t stream) {
  const long long n = static_cast<long long>(nbr) * k;
  if (n == 0) return repro::last_error();
  smoother_panel_kernel<BS><<<repro::blocks_for(n, threads), threads, 0,
                              stream>>>(idx, data, dinv, b, x, d, coef,
                                        x_out, d_out, nbr, kmax, k);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_fused_smoother_f64(const void* indices, const void* data,
                                       const void* dinv, const void* b,
                                       const void* x, const void* d,
                                       const void* coef, void* x_out,
                                       void* d_out, int nbr, int kmax,
                                       int bs, int threads, void* stream) {
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
  const int t = threads;
  if (!repro::threads_ok(t)) return repro::bad_shape();
  if (bs == 3)
    return launch<3>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, t, s);
  if (bs == 6)
    return launch<6>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, t, s);
  return repro::bad_shape();
}

REPRO_API int repro_fused_smoother_panel_f64(
    const void* indices, const void* data, const void* dinv, const void* b,
    const void* x, const void* d, const void* coef, void* x_out, void* d_out,
    int nbr, int kmax, int bs, int k, int threads, void* stream) {
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
  const int t = threads;
  if (k <= 0 || !repro::threads_ok(t)) return repro::bad_shape();
  if (bs == 3)
    return launch_panel<3>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, k,
                           t, s);
  if (bs == 6)
    return launch_panel<6>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, k,
                           t, s);
  return repro::bad_shape();
}
