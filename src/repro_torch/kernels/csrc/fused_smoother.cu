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
// Design: block_spmv's row body.  A sub-warp of `lanes` lanes owns one
// block row (for a panel, one chunk of KC columns of it): lane l walks the
// slots l, l + lanes, ... (ell_row_lanes), the partial sums meet in the
// fixed __dadd_rn butterfly (lanes_sum), and then every lane holds the
// row's A x.  `lanes` is the caller's ell_rows.lanes(bs, bs, kmax), the
// value block_spmv takes on the same operator, so the smoother's A x is
// bitwise block_spmv's.  Lane l then finishes the entries (a, j) with
// (a * KC + j) % lanes == l: res = b - A x, z = D^-1 res as an FMA chain
// over c ascending, and the recurrence with explicit roundings
// (__dmul_rn/__dadd_rn, never contracted to an FMA).  KC follows
// block_spmm's rule (k rounded up to a power of two, (bs + bs) * KC <= 48
// registers' worth); the chain of one (a, j) does not depend on KC, so a
// panel column is bitwise the vector step, which is the KC = 1, k = 1
// launch.  The chunks of one row sit on neighbouring sub-warps and read
// the same A blocks at about the same time.  `threads` (threads per
// block) sets threads / lanes sub-warps per block and nothing else, so
// every value gives the same result; launches of more than 512 threads
// run a build limited to 64 registers a thread.  x' is written out of
// place: the TPU kernel updates x while reading all of it, which on a
// parallel grid would race with the gathers of other rows.  [c1, c2]
// arrive as a two-element device tensor derived from the device scalar
// lambda_max, so no smoother step waits on the host; all columns share
// it.
#include "ell_row.cuh"

namespace {

template <int BS, int KC, int MAXT>
__global__ void __launch_bounds__(MAXT) smoother_kernel(
    const int* __restrict__ idx, const double* __restrict__ data,
    const double* __restrict__ dinv, const double* __restrict__ b,
    const double* __restrict__ x, const double* __restrict__ d,
    const double* __restrict__ coef, double* __restrict__ x_out,
    double* __restrict__ d_out, int nbr, int kmax, int k, int lanes) {
  // KC = 1 is launched only for k = 1: folded, the vector step indexes x
  // as block_spmv does (ld = 1, one column)
  if (KC == 1) k = 1;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  // sub-warp g owns chunk g % nchunk of row g / nchunk
  const long long g = t >> (__ffs(lanes) - 1);
  const int nchunk = (k + KC - 1) / KC;
  const long long r = g / nchunk;
  const int c0 = static_cast<int>(g % nchunk) * KC;
  const int ncol = k - c0 < KC ? k - c0 : KC;
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = r < nbr;
  // rows past nbr run no slot but still join the butterfly
  const long long rr = live ? r : 0;
  double acc[BS][KC];
  repro::ell_row_lanes<BS, BS, KC>(idx + rr * kmax,
                                   data + rr * kmax * BS * BS, x + c0, k,
                                   ncol, live ? kmax : 0, lane, lanes, acc);
  repro::lanes_sum<BS, KC>(acc, lanes);
  if (!live) return;
  // entry (a, j) of the chunk sits at (o + a) * k + j from column c0
  const long long o = r * BS;
#pragma unroll
  for (int a = 0; a < BS; ++a) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (j < ncol) acc[a][j] = b[(o + a) * k + c0 + j] - acc[a][j];
  }
  const double* di = dinv + r * BS * BS;
  const double c1 = coef[0];
  const double c2 = coef[1];
#pragma unroll
  for (int a = 0; a < BS; ++a) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (((a * KC + j) & (lanes - 1)) != lane || j >= ncol) continue;
      double z = 0.0;
#pragma unroll
      for (int c = 0; c < BS; ++c) z = fma(di[a * BS + c], acc[c][j], z);
      const long long e = (o + a) * k + c0 + j;
      const double dn = __dadd_rn(__dmul_rn(c1, d[e]), __dmul_rn(c2, z));
      d_out[e] = dn;
      x_out[e] = __dadd_rn(x[e], dn);
    }
  }
}

template <int BS, int KC>
int launch_kc(const int* idx, const double* data, const double* dinv,
              const double* b, const double* x, const double* d,
              const double* coef, double* x_out, double* d_out, int nbr,
              int kmax, int k, int lanes, int threads, cudaStream_t stream) {
  const long long groups = static_cast<long long>(nbr) * ((k + KC - 1) / KC);
  const unsigned blocks = repro::blocks_for(groups * lanes, threads);
  if (threads > 512)
    smoother_kernel<BS, KC, 1024><<<blocks, threads, 0, stream>>>(
        idx, data, dinv, b, x, d, coef, x_out, d_out, nbr, kmax, k, lanes);
  else
    smoother_kernel<BS, KC, 512><<<blocks, threads, 0, stream>>>(
        idx, data, dinv, b, x, d, coef, x_out, d_out, nbr, kmax, k, lanes);
  return repro::last_error();
}

// k = 1 is the vector step (KC = 1, ld = 1).
template <int BS>
int launch(const int* idx, const double* data, const double* dinv,
           const double* b, const double* x, const double* d,
           const double* coef, double* x_out, double* d_out, int nbr,
           int kmax, int k, int lanes, int threads, cudaStream_t stream) {
  if (!repro::payload_ok<BS>(data)) return repro::bad_shape();
  if (nbr == 0) return repro::last_error();
  if constexpr ((BS + BS) * 8 <= 48) {
    if (k > 4)
      return launch_kc<BS, 8>(idx, data, dinv, b, x, d, coef, x_out, d_out,
                              nbr, kmax, k, lanes, threads, stream);
  }
  if (k > 2)
    return launch_kc<BS, 4>(idx, data, dinv, b, x, d, coef, x_out, d_out,
                            nbr, kmax, k, lanes, threads, stream);
  if (k > 1)
    return launch_kc<BS, 2>(idx, data, dinv, b, x, d, coef, x_out, d_out,
                            nbr, kmax, k, lanes, threads, stream);
  return launch_kc<BS, 1>(idx, data, dinv, b, x, d, coef, x_out, d_out, nbr,
                          kmax, k, lanes, threads, stream);
}

int entry(const void* indices, const void* data, const void* dinv,
          const void* b, const void* x, const void* d, const void* coef,
          void* x_out, void* d_out, int nbr, int kmax, int bs, int k,
          int lanes, int threads, void* stream) {
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
  const int t = threads, l = lanes;
  if (k <= 0 || !repro::threads_ok(t) || !repro::lanes_ok(l))
    return repro::bad_shape();
  if (bs == 3)
    return launch<3>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, k, l, t,
                     s);
  if (bs == 6)
    return launch<6>(i, a, di, bv, xv, dv, cf, xo, dout, nbr, kmax, k, l, t,
                     s);
  return repro::bad_shape();
}

}  // namespace

REPRO_API int repro_fused_smoother_f64(const void* indices, const void* data,
                                       const void* dinv, const void* b,
                                       const void* x, const void* d,
                                       const void* coef, void* x_out,
                                       void* d_out, int nbr, int kmax,
                                       int bs, int lanes, int threads,
                                       void* stream) {
  return entry(indices, data, dinv, b, x, d, coef, x_out, d_out, nbr, kmax,
               bs, 1, lanes, threads, stream);
}

REPRO_API int repro_fused_smoother_panel_f64(
    const void* indices, const void* data, const void* dinv, const void* b,
    const void* x, const void* d, const void* coef, void* x_out, void* d_out,
    int nbr, int kmax, int bs, int k, int lanes, int threads, void* stream) {
  return entry(indices, data, dinv, b, x, d, coef, x_out, d_out, nbr, kmax,
               bs, k, lanes, threads, stream);
}
