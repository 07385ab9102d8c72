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
// card's fp64 balance.  At the solver's shapes (95,232 outputs and less)
// one launch moves at most 4.6 MB, about 1.4 us at the card's memory
// rate, while a launch of the empty kernel takes about 2.2 us on an H100
// (chip_smoke.py `launch floor`): the launch sets the time.
//
// Design: one thread per output element (n, a), so a launch has nbr*bs
// threads and neighbouring threads read neighbouring rows of dinv (one
// contiguous stream per warp) and the same r block (broadcast from L1);
// every load of a thread is independent, so all are in flight at once.
// Each thread sums its row over b ascending with FMAs, then rounds
// omega * y and x + omega * y apart (__dmul_rn/__dadd_rn, never
// contracted), as the plain version does.  omega comes by value when the
// caller has a number — a second launch to write it to the device would
// cost as much as this kernel — or as a one-element device tensor, read
// there, so no launch waits on the host.  A variant that staged each
// CTA's dinv and r runs in shared memory with 16-byte loads (and spread
// the coarse levels over all SMs) ran 10-12% slower on every case
// (PERF.md, Findings).  The block size is the autotuner's `threads`
// knob.
#include "common.cuh"

namespace {

template <int BS>
__global__ void pbjacobi_kernel(const double* __restrict__ dinv,
                                const double* __restrict__ r,
                                const double* __restrict__ x,
                                const double* __restrict__ omega,
                                double omega_value,
                                double* __restrict__ out, long long n) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const double* d = dinv + t * BS;          // row a of block row t / BS
  const double* rb = r + (t / BS) * BS;
  double y = 0.0;
#pragma unroll
  for (int b = 0; b < BS; ++b) y = fma(d[b], rb[b], y);
  const double w = omega ? omega[0] : omega_value;
  out[t] = __dadd_rn(x[t], __dmul_rn(w, y));
}

template <int BS>
int launch(const double* dinv, const double* r, const double* x,
           const double* omega, double omega_value, double* out, int nbr,
           int threads, cudaStream_t stream) {
  const long long n = static_cast<long long>(nbr) * BS;
  if (n == 0) return repro::last_error();
  const unsigned blocks = repro::blocks_for(n, threads);
  repro::note_launch(blocks, threads);
  pbjacobi_kernel<BS><<<blocks, threads, 0, stream>>>(dinv, r, x, omega,
                                                      omega_value, out, n);
  return repro::last_error();
}

}  // namespace

// omega: a one-element device array, or null to use omega_value.
REPRO_API int repro_pbjacobi_f64(const void* dinv, const void* r,
                                 const void* x, const void* omega,
                                 double omega_value, void* out, int nbr,
                                 int bs, int threads, void* stream) {
  auto di = static_cast<const double*>(dinv);
  auto rv = static_cast<const double*>(r);
  auto xv = static_cast<const double*>(x);
  auto w = static_cast<const double*>(omega);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (!repro::threads_ok(threads)) return repro::bad_shape();
  if (bs == 3)
    return launch<3>(di, rv, xv, w, omega_value, o, nbr, threads, s);
  if (bs == 6)
    return launch<6>(di, rv, xv, w, omega_value, o, nbr, threads, s);
  return repro::bad_shape();
}
