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
//
// Payloads: f64, f32 and bf16, at the reference's accumulator rule
// (src/repro/kernels/fused_smoother/fused_smoother.py:59-70; num.cuh): A x,
// the residual, D^-1 r, the recurrence and the update run at the
// accumulator and x', d' are rounded once to the payload type.  Entries:
// _f64 and _f32 (acc = the payload), _bf16 (acc = bf16, the bf16
// V-cycle's: A x and D^-1 r each sum at f32 and round to bf16, every
// elementwise step rounds to bf16) and _bf16_f32 (an f32 accumulator).
// [c1, c2] come at the payload type and are widened to the accumulator.
//
// Scalar rows (repro_fused_smoother_scalar_*): the scalar (AIJ) baseline
// (core/scalar_path.py) keeps A in 1x1 ELL rows but D^-1 in the node
// blocks of the blocked setup, (nbr, bs, bs) with bs in {3, 6}: node I
// owns the scalar rows I*bs .. I*bs+bs-1.  A sub-warp of `lanes` lanes
// (the caller's ell_rows.lanes(1, 1, kmax), block_spmv's at 1x1) owns one
// node and runs the 1x1 row body (ell_row_lanes + lanes_sum) on its bs
// rows in turn, so each row's A x is bitwise block_spmv's at 1x1; the bs
// residuals then meet dinv[I] in the blocked step's z chain and
// recurrence.  Vector only (the reference reaches it only through vector
// solves); `threads` sets threads / lanes nodes per block and nothing
// else.
#include "ell_row.cuh"

namespace {

template <int BS, int KC, int MAXT, typename T, typename Acc>
__global__ void __launch_bounds__(MAXT) smoother_kernel(
    const int* __restrict__ idx, const T* __restrict__ data,
    const T* __restrict__ dinv, const T* __restrict__ b,
    const T* __restrict__ x, const T* __restrict__ d,
    const T* __restrict__ coef, T* __restrict__ x_out,
    T* __restrict__ d_out, int nbr, int kmax, int k, int lanes) {
  using N = repro::Num<Acc>;
  using R = typename N::R;
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
  R acc[BS][KC];
  repro::ell_row_lanes<BS, BS, KC, T, Acc>(idx + rr * kmax,
                                           data + rr * kmax * BS * BS,
                                           x + c0, k, ncol, live ? kmax : 0,
                                           lane, lanes, acc);
  repro::lanes_sum<BS, KC, Acc>(acc, lanes);
  if (!live) return;
  // entry (a, j) of the chunk sits at (o + a) * k + j from column c0
  const long long o = r * BS;
#pragma unroll
  for (int a = 0; a < BS; ++a) {
#pragma unroll
    for (int j = 0; j < KC; ++j)
      if (j < ncol)
        acc[a][j] = N::sub(repro::widen(b[(o + a) * k + c0 + j]),
                           N::round(acc[a][j]));
  }
  const T* di = dinv + r * BS * BS;
  const R c1 = repro::widen(coef[0]);
  const R c2 = repro::widen(coef[1]);
#pragma unroll
  for (int a = 0; a < BS; ++a) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (((a * KC + j) & (lanes - 1)) != lane || j >= ncol) continue;
      R z = R(0);
#pragma unroll
      for (int c = 0; c < BS; ++c)
        z = N::fma(repro::widen(di[a * BS + c]), acc[c][j], z);
      z = N::round(z);
      const long long e = (o + a) * k + c0 + j;
      const R dn = N::add(N::mul(c1, repro::widen(d[e])), N::mul(c2, z));
      d_out[e] = repro::narrow<T>(dn);
      x_out[e] = repro::narrow<T>(N::add(repro::widen(x[e]), dn));
    }
  }
}

// One node of the scalar-row step per sub-warp (see the header).
template <int BS, typename T, typename Acc>
__global__ void __launch_bounds__(1024) scalar_smoother_kernel(
    const int* __restrict__ idx, const T* __restrict__ data,
    const T* __restrict__ dinv, const T* __restrict__ b,
    const T* __restrict__ x, const T* __restrict__ d,
    const T* __restrict__ coef, T* __restrict__ x_out,
    T* __restrict__ d_out, int nbr, int kmax, int lanes) {
  using N = repro::Num<Acc>;
  using R = typename N::R;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long r = t >> (__ffs(lanes) - 1);
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = r < nbr;
  // nodes past nbr run no slot but still join the butterflies
  const long long rr = live ? r : 0;
  R res[BS];
#pragma unroll
  for (int a = 0; a < BS; ++a) {
    const long long row = rr * BS + a;
    R acc[1][1];
    repro::ell_row_lanes<1, 1, 1, T, Acc>(idx + row * kmax,
                                          data + row * kmax, x, 1, 1,
                                          live ? kmax : 0, lane, lanes, acc);
    repro::lanes_sum<1, 1, Acc>(acc, lanes);
    res[a] = acc[0][0];
  }
  if (!live) return;
  const long long o = r * BS;
#pragma unroll
  for (int a = 0; a < BS; ++a)
    res[a] = N::sub(repro::widen(b[o + a]), N::round(res[a]));
  const T* di = dinv + r * BS * BS;
  const R c1 = repro::widen(coef[0]);
  const R c2 = repro::widen(coef[1]);
#pragma unroll
  for (int a = 0; a < BS; ++a) {
    if ((a & (lanes - 1)) != lane) continue;
    R z = R(0);
#pragma unroll
    for (int c = 0; c < BS; ++c)
      z = N::fma(repro::widen(di[a * BS + c]), res[c], z);
    z = N::round(z);
    const long long e = o + a;
    const R dn = N::add(N::mul(c1, repro::widen(d[e])), N::mul(c2, z));
    d_out[e] = repro::narrow<T>(dn);
    x_out[e] = repro::narrow<T>(N::add(repro::widen(x[e]), dn));
  }
}

template <typename T>
struct Args {
  const int* idx;
  const T *data, *dinv, *b, *x, *d, *coef;
  T *x_out, *d_out;
  int nbr, kmax, k, lanes, threads;
  cudaStream_t stream;
};

template <int BS, int KC, typename T, typename Acc>
int launch_kc(const Args<T>& a) {
  const long long groups =
      static_cast<long long>(a.nbr) * ((a.k + KC - 1) / KC);
  const unsigned blocks = repro::blocks_for(groups * a.lanes, a.threads);
  repro::note_launch(blocks, a.threads);
  if (a.threads > 512)
    smoother_kernel<BS, KC, 1024, T, Acc><<<blocks, a.threads, 0, a.stream>>>(
        a.idx, a.data, a.dinv, a.b, a.x, a.d, a.coef, a.x_out, a.d_out,
        a.nbr, a.kmax, a.k, a.lanes);
  else
    smoother_kernel<BS, KC, 512, T, Acc><<<blocks, a.threads, 0, a.stream>>>(
        a.idx, a.data, a.dinv, a.b, a.x, a.d, a.coef, a.x_out, a.d_out,
        a.nbr, a.kmax, a.k, a.lanes);
  return repro::last_error();
}

// k = 1 is the vector step (KC = 1, ld = 1).
template <int BS, typename T, typename Acc>
int launch(const Args<T>& a) {
  if (!repro::payload_ok<BS, T>(a.data)) return repro::bad_shape();
  if (a.nbr == 0) return repro::last_error();
  if constexpr ((BS + BS) * 8 <= 48) {
    if (a.k > 4) return launch_kc<BS, 8, T, Acc>(a);
  }
  if (a.k > 2) return launch_kc<BS, 4, T, Acc>(a);
  if (a.k > 1) return launch_kc<BS, 2, T, Acc>(a);
  return launch_kc<BS, 1, T, Acc>(a);
}

template <typename T, typename Acc>
int entry(const void* indices, const void* data, const void* dinv,
          const void* b, const void* x, const void* d, const void* coef,
          void* x_out, void* d_out, int nbr, int kmax, int bs, int k,
          int lanes, int threads, void* stream) {
  const Args<T> a{static_cast<const int*>(indices),
                  static_cast<const T*>(data),
                  static_cast<const T*>(dinv),
                  static_cast<const T*>(b),
                  static_cast<const T*>(x),
                  static_cast<const T*>(d),
                  static_cast<const T*>(coef),
                  static_cast<T*>(x_out),
                  static_cast<T*>(d_out),
                  nbr, kmax, k, lanes, threads,
                  static_cast<cudaStream_t>(stream)};
  if (k <= 0 || !repro::threads_ok(threads) || !repro::lanes_ok(lanes))
    return repro::bad_shape();
  if (bs == 3) return launch<3, T, Acc>(a);
  if (bs == 6) return launch<6, T, Acc>(a);
  return repro::bad_shape();
}

template <int BS, typename T, typename Acc>
int launch_scalar(const Args<T>& a) {
  if (a.nbr == 0) return repro::last_error();
  const unsigned blocks =
      repro::blocks_for(static_cast<long long>(a.nbr) * a.lanes, a.threads);
  repro::note_launch(blocks, a.threads);
  scalar_smoother_kernel<BS, T, Acc><<<blocks, a.threads, 0, a.stream>>>(
      a.idx, a.data, a.dinv, a.b, a.x, a.d, a.coef, a.x_out, a.d_out, a.nbr,
      a.kmax, a.lanes);
  return repro::last_error();
}

// nbr counts nodes: the ELL has nbr * bs scalar rows of kmax slots.
template <typename T, typename Acc>
int scalar_entry(const void* indices, const void* data, const void* dinv,
                 const void* b, const void* x, const void* d,
                 const void* coef, void* x_out, void* d_out, int nbr,
                 int kmax, int bs, int lanes, int threads, void* stream) {
  const Args<T> a{static_cast<const int*>(indices),
                  static_cast<const T*>(data),
                  static_cast<const T*>(dinv),
                  static_cast<const T*>(b),
                  static_cast<const T*>(x),
                  static_cast<const T*>(d),
                  static_cast<const T*>(coef),
                  static_cast<T*>(x_out),
                  static_cast<T*>(d_out),
                  nbr, kmax, 1, lanes, threads,
                  static_cast<cudaStream_t>(stream)};
  if (!repro::threads_ok(threads) || !repro::lanes_ok(lanes))
    return repro::bad_shape();
  if (bs == 3) return launch_scalar<3, T, Acc>(a);
  if (bs == 6) return launch_scalar<6, T, Acc>(a);
  return repro::bad_shape();
}

}  // namespace

#define REPRO_SMOOTHER_ENTRIES(SUFFIX, T, ACC)                               \
  REPRO_API int repro_fused_smoother_##SUFFIX(                               \
      const void* indices, const void* data, const void* dinv,               \
      const void* b, const void* x, const void* d, const void* coef,         \
      void* x_out, void* d_out, int nbr, int kmax, int bs, int lanes,        \
      int threads, void* stream) {                                           \
    return entry<T, ACC>(indices, data, dinv, b, x, d, coef, x_out, d_out,   \
                         nbr, kmax, bs, 1, lanes, threads, stream);          \
  }                                                                          \
  REPRO_API int repro_fused_smoother_panel_##SUFFIX(                         \
      const void* indices, const void* data, const void* dinv,               \
      const void* b, const void* x, const void* d, const void* coef,         \
      void* x_out, void* d_out, int nbr, int kmax, int bs, int k,            \
      int lanes, int threads, void* stream) {                                \
    return entry<T, ACC>(indices, data, dinv, b, x, d, coef, x_out, d_out,   \
                         nbr, kmax, bs, k, lanes, threads, stream);          \
  }                                                                          \
  REPRO_API int repro_fused_smoother_scalar_##SUFFIX(                        \
      const void* indices, const void* data, const void* dinv,               \
      const void* b, const void* x, const void* d, const void* coef,         \
      void* x_out, void* d_out, int nbr, int kmax, int bs, int lanes,        \
      int threads, void* stream) {                                           \
    return scalar_entry<T, ACC>(indices, data, dinv, b, x, d, coef, x_out,   \
                                d_out, nbr, kmax, bs, lanes, threads,        \
                                stream);                                     \
  }

REPRO_SMOOTHER_ENTRIES(f64, double, double)
REPRO_SMOOTHER_ENTRIES(f32, float, float)
REPRO_SMOOTHER_ENTRIES(bf16, repro::bf16, repro::bf16)
REPRO_SMOOTHER_ENTRIES(bf16_f32, repro::bf16, float)
