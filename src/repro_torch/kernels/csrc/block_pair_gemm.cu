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
//
// Payloads: f64, f32 and bf16, at the reference's accumulator rule
// (num.cuh): operands widened on-register, contracted at f64 / f32 / f32.
// _f64, _f32 and _bf16 round the products to the payload type;
// _bf16_f32 keeps them at the f32 accumulator — the pairs path's products
// stay there until block_seg_sum has combined them (src/repro/core/
// spgemm.py:288-301), and reading the bf16 operands instead of f32 copies
// of them halves the operand bytes of that path.
#include "common.cuh"
#include "num.cuh"

namespace {

template <int BR, int BK, int BC, typename T, typename O>
__global__ void block_pair_gemm_kernel(const T* __restrict__ lhs,
                                       const T* __restrict__ rhs,
                                       O* __restrict__ out, long long n) {
  using N = repro::Num<typename repro::Elem<T>::W>;
  constexpr int AREA = BR * BC;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (t >= n) return;
  const long long p = t / AREA;
  const int e = static_cast<int>(t % AREA);
  const int i = e / BC;
  const int l = e % BC;
  const T* a = lhs + p * BR * BK + i * BK;
  const T* b = rhs + p * BK * BC + l;
  typename N::R acc = 0;
#pragma unroll
  for (int j = 0; j < BK; ++j)
    acc = N::fma(repro::widen(a[j]), repro::widen(b[j * BC]), acc);
  out[t] = repro::narrow<O>(acc);
}

template <int BR, int BK, int BC, typename T, typename O>
int launch(const T* lhs, const T* rhs, O* out, int npairs,
           cudaStream_t stream) {
  const long long n = static_cast<long long>(npairs) * BR * BC;
  if (n == 0) return repro::last_error();
  const unsigned blocks = repro::blocks_for(n, repro::kThreads);
  repro::note_launch(blocks, repro::kThreads);
  block_pair_gemm_kernel<BR, BK, BC, T, O>
      <<<blocks, repro::kThreads, 0, stream>>>(lhs, rhs, out, n);
  return repro::last_error();
}

template <typename T, typename O>
int entry(const void* lhs, const void* rhs, void* out, int npairs, int br,
          int bk, int bc, void* stream) {
  auto a = static_cast<const T*>(lhs);
  auto b = static_cast<const T*>(rhs);
  auto o = static_cast<O*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (br == 3 && bk == 3 && bc == 6)
    return launch<3, 3, 6, T, O>(a, b, o, npairs, s);
  if (br == 6 && bk == 3 && bc == 6)
    return launch<6, 3, 6, T, O>(a, b, o, npairs, s);
  if (br == 6 && bk == 6 && bc == 6)
    return launch<6, 6, 6, T, O>(a, b, o, npairs, s);
  return repro::bad_shape();
}

}  // namespace

#define REPRO_PAIR_GEMM_ENTRY(SUFFIX, T, O)                                  \
  REPRO_API int repro_block_pair_gemm_##SUFFIX(                              \
      const void* lhs, const void* rhs, void* out, int npairs, int br,       \
      int bk, int bc, void* stream) {                                        \
    return entry<T, O>(lhs, rhs, out, npairs, br, bk, bc, stream);           \
  }

REPRO_PAIR_GEMM_ENTRY(f64, double, double)
REPRO_PAIR_GEMM_ENTRY(f32, float, float)
REPRO_PAIR_GEMM_ENTRY(bf16, repro::bf16, repro::bf16)
REPRO_PAIR_GEMM_ENTRY(bf16_f32, repro::bf16, float)
