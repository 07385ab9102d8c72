// block_pair_gemm — batched rectangular block GEMM of the unfused
// ("pairs") Galerkin path, on Hopper:
//   out[p] = lhs[p] @ rhs[p],  (npairs, br, bk) @ (npairs, bk, bc).
//
// Replaces the TPU kernel repro/kernels/block_pair_gemm/block_pair_gemm.py
// (block_pair_gemm / _pair_gemm_kernel).  The operands arrive gathered
// (the pairs path builds them, then block_seg_sum reduces the products by
// output block): this path is the PtAP ablation's unfused baseline, and
// materialising those streams is its point; fused_pair_gemm is the path
// that avoids them.
//
// Bound: bytes — each pair reads br*bk + bk*bc doubles and writes br*bc;
// 2*br*bk*bc flops per pair stay far below the fp64 balance.  Design
// (first, plain): one thread per (pair, output element i, l), so a pair's
// br*bc threads are neighbours and read its lhs rows and rhs columns from
// the same few cache lines; the bk contraction is accumulated with FMAs
// in the TPU kernel's order (j = 0 .. bk-1).
#include "common.cuh"

namespace {

template <int BR, int BK, int BC>
__global__ void block_pair_gemm_kernel(const double* __restrict__ lhs,
                                       const double* __restrict__ rhs,
                                       double* __restrict__ out,
                                       long long n) {
  constexpr int AREA = BR * BC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const long long p = t / AREA;
  const int e = static_cast<int>(t % AREA);
  const int i = e / BC;
  const int l = e % BC;
  const double* a = lhs + p * BR * BK + i * BK;
  const double* b = rhs + p * BK * BC + l;
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < BK; ++j) acc = fma(a[j], b[j * BC], acc);
  out[t] = acc;
}

template <int BR, int BK, int BC>
int launch(const double* lhs, const double* rhs, double* out, int npairs,
           cudaStream_t stream) {
  const long long n = static_cast<long long>(npairs) * BR * BC;
  if (n == 0) return repro::last_error();
  const unsigned blocks = repro::blocks_for(n, repro::kThreads);
  repro::note_launch(blocks, repro::kThreads);
  block_pair_gemm_kernel<BR, BK, BC><<<blocks, repro::kThreads, 0, stream>>>(
      lhs, rhs, out, n);
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_block_pair_gemm_f64(const void* lhs, const void* rhs,
                                        void* out, int npairs, int br,
                                        int bk, int bc, void* stream) {
  auto a = static_cast<const double*>(lhs);
  auto b = static_cast<const double*>(rhs);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (br == 3 && bk == 3 && bc == 6) return launch<3, 3, 6>(a, b, o, npairs, s);
  if (br == 6 && bk == 3 && bc == 6) return launch<6, 3, 6>(a, b, o, npairs, s);
  if (br == 6 && bk == 6 && bc == 6) return launch<6, 6, 6>(a, b, o, npairs, s);
  return repro::bad_shape();
}
