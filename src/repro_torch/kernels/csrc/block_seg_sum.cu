// block_seg_sum — sorted segment sum of a block stream, on Hopper.
//
// Replaces the TPU kernel repro/kernels/block_seg_sum/block_seg_sum.py
// (block_stream_cumsum + the ops.py boundary difference).  That kernel is a
// prefix sum carried across the TPU's sequential grid, then
// csum[end] - csum[start]: Hopper runs blocks in parallel with no carry,
// and the difference of prefixes cancels.  This kernel computes the
// function directly instead: out[s] = sum of vals[src(j)] for j in
// [offsets[s], offsets[s+1]), summed in stream order, with src(j) = perm[j]
// (the COO plan's composed keep[order] permutation, so the sorted copy of
// the value stream is never written) or j (perm == nullptr, the SpGEMM
// row-split combine).
//
// Bound: bytes.  Each input block is read once and each output block
// written once, at one add per input double; the segment bounds come from
// the host plan.  Design: one thread per (segment, block element), so the
// br*bc threads of a segment read neighbouring doubles of each block and
// write neighbouring outputs; every thread sums its run in order — no
// atomics, deterministic, reruns bitwise equal, and bitwise equal to the
// plain version's in-order sum.
//
// Block shapes: 3x3, 3x6 and 6x6, and 1x1 for the row-split combines of
// the scalar (AIJ) baseline's PtAP chain (core/scalar_path.py), where a
// thread sums one scalar segment.
//
// Payloads: f64 (the COO reassembly, at the Krylov dtype, and the f64
// combines), f32 and bf16 (the row-split combines of a reduced-precision
// recompute).  f64 and f32 sum at their own type; bf16 sums at an f32
// accumulator and rounds once (src/repro/core/spgemm.py:328-335: the
// partials are cast up, summed and rounded), never at bf16.
#include "common.cuh"
#include "num.cuh"

namespace {

template <int BR, int BC, typename T, typename Acc>
__global__ void seg_sum_kernel(const T* __restrict__ vals,
                               const int* __restrict__ perm,
                               const int* __restrict__ offsets,
                               T* __restrict__ out, int nseg) {
  using N = repro::Num<Acc>;
  constexpr int AREA = BR * BC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nseg) * AREA) return;
  const int seg = static_cast<int>(t / AREA);
  const int e = static_cast<int>(t % AREA);
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  typename N::R acc = 0;
  for (int j = begin; j < end; ++j) {
    const long long src = perm ? static_cast<long long>(perm[j])
                               : static_cast<long long>(j);
    acc = N::cadd(acc, repro::widen(vals[src * AREA + e]));
  }
  out[t] = repro::narrow<T>(acc);
}

template <int BR, int BC, typename T, typename Acc>
int launch(const T* vals, const int* perm, const int* offsets, T* out,
           int nseg, cudaStream_t stream) {
  const long long n = static_cast<long long>(nseg) * BR * BC;
  if (n == 0) return repro::last_error();
  const unsigned blocks = repro::blocks_for(n, repro::kThreads);
  repro::note_launch(blocks, repro::kThreads);
  seg_sum_kernel<BR, BC, T, Acc><<<blocks, repro::kThreads, 0, stream>>>(
      vals, perm, offsets, out, nseg);
  return repro::last_error();
}

template <typename T, typename Acc>
int entry(const void* vals, const void* perm, const void* offsets,
          void* out, int nseg, int br, int bc, void* stream) {
  auto v = static_cast<const T*>(vals);
  auto p = static_cast<const int*>(perm);
  auto o = static_cast<const int*>(offsets);
  auto y = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (br == 3 && bc == 3) return launch<3, 3, T, Acc>(v, p, o, y, nseg, s);
  if (br == 3 && bc == 6) return launch<3, 6, T, Acc>(v, p, o, y, nseg, s);
  if (br == 6 && bc == 6) return launch<6, 6, T, Acc>(v, p, o, y, nseg, s);
  if (br == 1 && bc == 1) return launch<1, 1, T, Acc>(v, p, o, y, nseg, s);
  return repro::bad_shape();
}

}  // namespace

#define REPRO_SEG_SUM_ENTRY(SUFFIX, T, ACC)                                  \
  REPRO_API int repro_block_seg_sum_##SUFFIX(                                \
      const void* vals, const void* perm, const void* offsets, void* out,    \
      int nseg, int br, int bc, void* stream) {                              \
    return entry<T, ACC>(vals, perm, offsets, out, nseg, br, bc, stream);    \
  }

REPRO_SEG_SUM_ENTRY(f64, double, double)
REPRO_SEG_SUM_ENTRY(f32, float, float)
REPRO_SEG_SUM_ENTRY(bf16, repro::bf16, float)
