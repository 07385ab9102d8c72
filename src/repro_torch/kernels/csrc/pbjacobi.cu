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
//
// Payloads: f64, f32 and bf16, at the reference's accumulator rule
// (src/repro/kernels/pbjacobi/ref.py; num.cuh): _f64 and _f32 at the
// payload type, _bf16 at acc = bf16 (the matvec sums at f32 and rounds to
// bf16, then omega * y and the sum each round to bf16), _bf16_f32 at an
// f32 accumulator, rounded once.  omega by value is rounded to the
// accumulator in the kernel; a device omega comes at the payload type.
#include "common.cuh"
#include "num.cuh"

namespace {

template <int BS, typename T, typename Acc>
__global__ void pbjacobi_kernel(const T* __restrict__ dinv,
                                const T* __restrict__ r,
                                const T* __restrict__ x,
                                const T* __restrict__ omega,
                                double omega_value,
                                T* __restrict__ out, long long n) {
  using N = repro::Num<Acc>;
  using R = typename N::R;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const T* d = dinv + t * BS;          // row a of block row t / BS
  const T* rb = r + (t / BS) * BS;
  R y = R(0);
#pragma unroll
  for (int b = 0; b < BS; ++b)
    y = N::fma(repro::widen(d[b]), repro::widen(rb[b]), y);
  y = N::round(y);
  const R w = omega ? N::round(repro::widen(omega[0]))
                    : N::from_double(omega_value);
  out[t] = repro::narrow<T>(N::add(repro::widen(x[t]), N::mul(w, y)));
}

template <int BS, typename T, typename Acc>
int launch(const T* dinv, const T* r, const T* x, const T* omega,
           double omega_value, T* out, int nbr, int threads,
           cudaStream_t stream) {
  const long long n = static_cast<long long>(nbr) * BS;
  if (n == 0) return repro::last_error();
  const unsigned blocks = repro::blocks_for(n, threads);
  repro::note_launch(blocks, threads);
  pbjacobi_kernel<BS, T, Acc><<<blocks, threads, 0, stream>>>(
      dinv, r, x, omega, omega_value, out, n);
  return repro::last_error();
}

template <typename T, typename Acc>
int entry(const void* dinv, const void* r, const void* x, const void* omega,
          double omega_value, void* out, int nbr, int bs, int threads,
          void* stream) {
  auto di = static_cast<const T*>(dinv);
  auto rv = static_cast<const T*>(r);
  auto xv = static_cast<const T*>(x);
  auto w = static_cast<const T*>(omega);
  auto o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (!repro::threads_ok(threads)) return repro::bad_shape();
  if (bs == 3)
    return launch<3, T, Acc>(di, rv, xv, w, omega_value, o, nbr, threads, s);
  if (bs == 6)
    return launch<6, T, Acc>(di, rv, xv, w, omega_value, o, nbr, threads, s);
  return repro::bad_shape();
}

}  // namespace

// omega: a one-element device array, or null to use omega_value.
#define REPRO_PBJACOBI_ENTRY(SUFFIX, T, ACC)                                 \
  REPRO_API int repro_pbjacobi_##SUFFIX(                                     \
      const void* dinv, const void* r, const void* x, const void* omega,     \
      double omega_value, void* out, int nbr, int bs, int threads,           \
      void* stream) {                                                        \
    return entry<T, ACC>(dinv, r, x, omega, omega_value, out, nbr, bs,       \
                         threads, stream);                                   \
  }

REPRO_PBJACOBI_ENTRY(f64, double, double)
REPRO_PBJACOBI_ENTRY(f32, float, float)
REPRO_PBJACOBI_ENTRY(bf16, repro::bf16, repro::bf16)
REPRO_PBJACOBI_ENTRY(bf16_f32, repro::bf16, float)
