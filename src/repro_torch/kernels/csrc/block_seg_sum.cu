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
#include "common.cuh"

namespace {

template <int BR, int BC>
__global__ void seg_sum_kernel(const double* __restrict__ vals,
                               const int* __restrict__ perm,
                               const int* __restrict__ offsets,
                               double* __restrict__ out, int nseg) {
  constexpr int AREA = BR * BC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= static_cast<long long>(nseg) * AREA) return;
  const int seg = static_cast<int>(t / AREA);
  const int e = static_cast<int>(t % AREA);
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];
  double acc = 0.0;
  for (int j = begin; j < end; ++j) {
    const long long src = perm ? static_cast<long long>(perm[j])
                               : static_cast<long long>(j);
    acc += vals[src * AREA + e];
  }
  out[t] = acc;
}

template <int BR, int BC>
int launch(const double* vals, const int* perm, const int* offsets,
           double* out, int nseg, cudaStream_t stream) {
  const long long n = static_cast<long long>(nseg) * BR * BC;
  if (n == 0) return repro::last_error();
  const unsigned blocks = repro::blocks_for(n, repro::kThreads);
  repro::note_launch(blocks, repro::kThreads);
  seg_sum_kernel<BR, BC><<<blocks, repro::kThreads, 0, stream>>>(
      vals, perm, offsets, out, nseg);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_block_seg_sum_f64(const void* vals, const void* perm,
                                      const void* offsets, void* out,
                                      int nseg, int br, int bc,
                                      void* stream) {
  auto v = static_cast<const double*>(vals);
  auto p = static_cast<const int*>(perm);
  auto o = static_cast<const int*>(offsets);
  auto y = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (br == 3 && bc == 3) return launch<3, 3>(v, p, o, y, nseg, s);
  if (br == 3 && bc == 6) return launch<3, 6>(v, p, o, y, nseg, s);
  if (br == 6 && bc == 6) return launch<6, 6>(v, p, o, y, nseg, s);
  return repro::bad_shape();
}
