// pbjacobi — the damped point-block Jacobi update on Hopper:
//   out[n] = x[n] + omega * dinv[n] @ r[n]   over (nbr, bs) block vectors,
// dinv (nbr, bs, bs) the inverted diagonal blocks, bs in {3, 6}.
//
// Replaces the TPU kernel repro/kernels/pbjacobi/pbjacobi.py
// (pbjacobi_update / _pbjacobi_kernel), a (TR, bs, bs) x (TR, bs) tile
// matvec per grid step.  In both packages the autotuner is its only
// caller; the solver's smoother applies D^-1 inside fused_smoother.
//
// Bound: bytes — dinv (nbr*bs*bs doubles), r, x and out (nbr*bs each)
// are each moved once; 2*bs*bs flops per block row are far below the
// card's fp64 balance.  Design (first, plain): one thread per output
// element (n, a), so a launch has nbr*bs threads and neighbouring threads
// read neighbouring rows of dinv (one contiguous stream per warp) and the
// same r block (broadcast from L1).  Each thread sums its row over b
// ascending with FMAs, then rounds omega * y and x + omega * y apart
// (__dmul_rn/__dadd_rn, never contracted), as the plain version does.
// omega arrives as a one-element device tensor, so no launch waits on
// the host.  The block size is the autotuner's `threads` knob.
#include "common.cuh"

namespace {

template <int BS>
__global__ void pbjacobi_kernel(const double* __restrict__ dinv,
                                const double* __restrict__ r,
                                const double* __restrict__ x,
                                const double* __restrict__ omega,
                                double* __restrict__ out, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const double* d = dinv + t * BS;          // row a of block row t / BS
  const double* rb = r + (t / BS) * BS;
  double y = 0.0;
#pragma unroll
  for (int b = 0; b < BS; ++b) y = fma(d[b], rb[b], y);
  out[t] = __dadd_rn(x[t], __dmul_rn(omega[0], y));
}

template <int BS>
int launch(const double* dinv, const double* r, const double* x,
           const double* omega, double* out, int nbr, int threads,
           cudaStream_t stream) {
  const long long n = static_cast<long long>(nbr) * BS;
  if (n == 0) return repro::last_error();
  pbjacobi_kernel<BS><<<repro::blocks_for(n, threads), threads, 0,
                        stream>>>(dinv, r, x, omega, out, n);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_pbjacobi_f64(const void* dinv, const void* r,
                                 const void* x, const void* omega, void* out,
                                 int nbr, int bs, int threads, void* stream) {
  auto di = static_cast<const double*>(dinv);
  auto rv = static_cast<const double*>(r);
  auto xv = static_cast<const double*>(x);
  auto w = static_cast<const double*>(omega);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (!repro::threads_ok(threads)) return repro::bad_shape();
  if (bs == 3) return launch<3>(di, rv, xv, w, o, nbr, threads, s);
  if (bs == 6) return launch<6>(di, rv, xv, w, o, nbr, threads, s);
  return repro::bad_shape();
}
