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
// is read and Y written once.  Design: block_spmv's sub-warp per block row
// with the same `lanes` (a function of br, bc and kmax alone) and the same
// row body (ell_row_lanes, lanes_sum).  A lane reads each of its A blocks
// once per chunk of KC columns and applies it to the chunk, held in
// registers: KC is k rounded up to a power of two, at most the largest
// power of two with (br + bc) * KC <= 48 registers' worth of x entries
// and sums (8 columns of 3x3 blocks, 4 of 3x6 and 6x6), so up to that
// width the operator is read once and beyond it once per chunk.  Per
// column the FMA chain and the butterfly are block_spmv's, so column j of
// Y is bitwise block_spmv of column j of X.  `threads` sets threads /
// lanes rows per block and nothing else; launches of more than 512
// threads run a build limited to 64 registers a thread.
//
// Payloads: f64, f32 and bf16 (repro_block_spmm_{f64,f32,bf16}), at
// block_spmv's accumulator rule (num.cuh; bf16 contracts at f32 and
// rounds once), so the per-column identity with block_spmv holds at every
// payload type.  KC is counted in registers of the accumulator, which is
// no wider than at f64.
#include "ell_row.cuh"

namespace {

template <int BR, int BC, int KC, int MAXT, typename T, typename Acc>
__global__ void __launch_bounds__(MAXT) spmm_kernel(const int* __restrict__ idx,
                            const T* __restrict__ data,
                            const T* __restrict__ x,
                            T* __restrict__ y, int nbr, int kmax,
                            int k, int lanes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long r = t >> (__ffs(lanes) - 1);
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = r < nbr;
  // rows past nbr run no slot but still join the butterfly
  const long long rr = live ? r : 0;
  const int* ri = idx + rr * kmax;
  const T* rd = data + rr * kmax * BR * BC;
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int ncol = k - c0 < KC ? k - c0 : KC;
    typename repro::Num<Acc>::R acc[BR][KC];
    repro::ell_row_lanes<BR, BC, KC, T, Acc>(ri, rd, x + c0, k, ncol,
                                             live ? kmax : 0, lane, lanes,
                                             acc);
    repro::lanes_sum<BR, KC, Acc>(acc, lanes);
    if (!live) continue;
    T* yr = y + r * BR * k + c0;
#pragma unroll
    for (int a = 0; a < BR; ++a) {
#pragma unroll
      for (int j = 0; j < KC; ++j)
        if (((a * KC + j) & (lanes - 1)) == lane && j < ncol)
          yr[static_cast<long long>(a) * k + j] =
              repro::narrow<T>(acc[a][j]);
    }
  }
}

template <int BR, int BC, int KC, typename T, typename Acc>
int launch_kc(const int* idx, const T* data, const T* x, T* y, int nbr,
              int kmax, int k, int lanes, int threads, cudaStream_t stream) {
  const unsigned blocks =
      repro::blocks_for(static_cast<long long>(nbr) * lanes, threads);
  repro::note_launch(blocks, threads);
  if (threads > 512)
    spmm_kernel<BR, BC, KC, 1024, T, Acc><<<blocks, threads, 0, stream>>>(
        idx, data, x, y, nbr, kmax, k, lanes);
  else
    spmm_kernel<BR, BC, KC, 512, T, Acc><<<blocks, threads, 0, stream>>>(
        idx, data, x, y, nbr, kmax, k, lanes);
  return repro::last_error();
}

template <int BR, int BC, typename T, typename Acc>
int launch(const int* idx, const T* data, const T* x, T* y, int nbr,
           int kmax, int k, int lanes, int threads, cudaStream_t stream) {
  if (!repro::payload_ok<BC, T>(data)) return repro::bad_shape();
  if (nbr == 0) return repro::last_error();
  if constexpr ((BR + BC) * 8 <= 48) {
    if (k > 4)
      return launch_kc<BR, BC, 8, T, Acc>(idx, data, x, y, nbr, kmax, k,
                                          lanes, threads, stream);
  }
  if (k > 2)
    return launch_kc<BR, BC, 4, T, Acc>(idx, data, x, y, nbr, kmax, k, lanes,
                                        threads, stream);
  if (k > 1)
    return launch_kc<BR, BC, 2, T, Acc>(idx, data, x, y, nbr, kmax, k, lanes,
                                        threads, stream);
  return launch_kc<BR, BC, 1, T, Acc>(idx, data, x, y, nbr, kmax, k, lanes,
                                      threads, stream);
}

template <typename T, typename Acc>
int entry(const void* indices, const void* data, const void* x, void* y,
          int nbr, int kmax, int br, int bc, int k, int lanes, int threads,
          void* stream) {
  auto i = static_cast<const int*>(indices);
  auto d = static_cast<const T*>(data);
  auto xv = static_cast<const T*>(x);
  auto yv = static_cast<T*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads, l = lanes;
  if (k <= 0 || !repro::threads_ok(t) || !repro::lanes_ok(l))
    return repro::bad_shape();
  if (br == 3 && bc == 3)
    return launch<3, 3, T, Acc>(i, d, xv, yv, nbr, kmax, k, l, t, s);
  if (br == 3 && bc == 6)
    return launch<3, 6, T, Acc>(i, d, xv, yv, nbr, kmax, k, l, t, s);
  if (br == 6 && bc == 6)
    return launch<6, 6, T, Acc>(i, d, xv, yv, nbr, kmax, k, l, t, s);
  return repro::bad_shape();
}

}  // namespace

#define REPRO_SPMM_ENTRY(SUFFIX, T, ACC)                                     \
  REPRO_API int repro_block_spmm_##SUFFIX(                                   \
      const void* indices, const void* data, const void* x, void* y,         \
      int nbr, int kmax, int br, int bc, int k, int lanes, int threads,      \
      void* stream) {                                                        \
    return entry<T, ACC>(indices, data, x, y, nbr, kmax, br, bc, k, lanes,   \
                         threads, stream);                                   \
  }

REPRO_SPMM_ENTRY(f64, double, double)
REPRO_SPMM_ENTRY(f32, float, float)
REPRO_SPMM_ENTRY(bf16, repro::bf16, float)
