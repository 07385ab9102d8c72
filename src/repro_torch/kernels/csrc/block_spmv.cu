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
// written once.  Design: a sub-warp of `lanes` lanes owns one block row
// (ell_row_lanes, shared with block_spmm).  Lane l walks the slots l,
// l + lanes, ... and neighbouring lanes read neighbouring slots, so the
// row's payload streams in lanes * br * bc consecutive doubles and the
// slot loop a lane runs in sequence is kmax / lanes long instead of kmax.
// The partials meet in a fixed xor butterfly, and the sub-warp's first
// lanes write the br outputs once.  `lanes` comes from the caller, a
// function of (br, bc, kmax) alone (kernels/ell_rows.py): wide sub-warps
// for the wide coarse rows, narrow ones for the fine level.  `threads`
// (threads per block) sets threads / lanes rows per block and nothing
// else, so the reduction order of a row does not depend on it.  Padded
// slots are zero blocks pointing at column 0: they add exact zeros and
// need no mask.  A lane reads each block row of its slot in 16-byte pairs
// where the block width is even (payloads must then be 16-byte aligned).
// Block shapes: 3x3 (A0), 3x6 (P0), 6x6 (coarse A, P), 6x3, the stored
// restriction R0 = P0^T (gamg.setup(restriction="stored")), and 1x1, the
// scalar (AIJ) baseline's every A x, P x and R r (core/scalar_path.py):
// there a row's slots are single doubles and its lanes read consecutive
// ones.  Odd-width rows take the element-wise loads.
#include "ell_row.cuh"

namespace {

template <int BR, int BC, typename T, typename Acc>
__global__ void __launch_bounds__(1024) spmv_kernel(const int* __restrict__ idx,
                            const T* __restrict__ data,
                            const T* __restrict__ x,
                            T* __restrict__ y, int nbr, int kmax,
                            int lanes) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long r = t >> (__ffs(lanes) - 1);
  const int lane = threadIdx.x & (lanes - 1);
  const bool live = r < nbr;
  // rows past nbr run no slot but still join the butterfly
  const long long rr = live ? r : 0;
  typename repro::Num<Acc>::R acc[BR][1];
  repro::ell_row_lanes<BR, BC, 1, T, Acc>(idx + rr * kmax,
                                          data + rr * kmax * BR * BC, x, 1,
                                          1, live ? kmax : 0, lane, lanes,
                                          acc);
  repro::lanes_sum<BR, 1, Acc>(acc, lanes);
  if (!live) return;
  T* yr = y + r * BR;
#pragma unroll
  for (int a = 0; a < BR; ++a)
    if ((a & (lanes - 1)) == lane) yr[a] = repro::narrow<T>(acc[a][0]);
}

template <int BR, int BC, typename T, typename Acc>
int launch(const int* idx, const T* data, const T* x, T* y, int nbr,
           int kmax, int lanes, int threads, cudaStream_t stream) {
  if (!repro::payload_ok<BC, T>(data)) return repro::bad_shape();
  if (nbr == 0) return repro::last_error();
  const unsigned blocks =
      repro::blocks_for(static_cast<long long>(nbr) * lanes, threads);
  repro::note_launch(blocks, threads);
  spmv_kernel<BR, BC, T, Acc><<<blocks, threads, 0, stream>>>(
      idx, data, x, y, nbr, kmax, lanes);
  return repro::last_error();
}

template <typename T, typename Acc>
int entry(const void* indices, const void* data, const void* x, void* y,
          int nbr, int kmax, int br, int bc, int lanes, int threads,
          void* stream) {
  auto i = static_cast<const int*>(indices);
  auto d = static_cast<const T*>(data);
  auto xv = static_cast<const T*>(x);
  auto yv = static_cast<T*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads, l = lanes;
  if (!repro::threads_ok(t) || !repro::lanes_ok(l)) return repro::bad_shape();
  if (br == 3 && bc == 3)
    return launch<3, 3, T, Acc>(i, d, xv, yv, nbr, kmax, l, t, s);
  if (br == 3 && bc == 6)
    return launch<3, 6, T, Acc>(i, d, xv, yv, nbr, kmax, l, t, s);
  if (br == 6 && bc == 6)
    return launch<6, 6, T, Acc>(i, d, xv, yv, nbr, kmax, l, t, s);
  if (br == 6 && bc == 3)
    return launch<6, 3, T, Acc>(i, d, xv, yv, nbr, kmax, l, t, s);
  if (br == 1 && bc == 1)
    return launch<1, 1, T, Acc>(i, d, xv, yv, nbr, kmax, l, t, s);
  return repro::bad_shape();
}

}  // namespace

#define REPRO_SPMV_ENTRY(SUFFIX, T, ACC)                                     \
  REPRO_API int repro_block_spmv_##SUFFIX(                                   \
      const void* indices, const void* data, const void* x, void* y,         \
      int nbr, int kmax, int br, int bc, int lanes, int threads,             \
      void* stream) {                                                        \
    return entry<T, ACC>(indices, data, x, y, nbr, kmax, br, bc, lanes,      \
                         threads, stream);                                   \
  }

REPRO_SPMV_ENTRY(f64, double, double)
REPRO_SPMV_ENTRY(f32, float, float)
REPRO_SPMV_ENTRY(bf16, repro::bf16, float)
