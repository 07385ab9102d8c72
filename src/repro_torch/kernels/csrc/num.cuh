// Payload and accumulator types of the kernels (the reference's
// accumulator rule, src/repro/kernels/block_spmv/block_spmv.py:15-21):
// operands are cast up on-register, contracted at the accumulator `acc`
// and rounded once to the payload type on the way out.
//
// Payload types T: double, float, __nv_bfloat16.  Accumulators Acc:
//   double  — f64 payloads; every body keeps its f64 arithmetic as it was
//             (fma, __dadd_rn, __dmul_rn), so the f64 results do not move.
//   float   — f32 payloads, and bf16 payloads with an f32 accumulator:
//             fmaf / __fadd_rn / __fmul_rn in the f64 body's order.
//   __nv_bfloat16 — bf16 payloads with acc = bf16 (the bf16 V-cycle):
//             each contraction sums at f32 and rounds once to bf16 (what
//             one einsum with preferred_element_type=bf16 computes), and
//             every elementwise step rounds to bf16 on its own.
// Num<Acc>::R is the register type; `fma` / `cadd` are the contraction's
// (never rounded to bf16), `round` takes a finished contraction to the
// accumulator's precision, and `add` / `sub` / `mul` are elementwise
// steps at the accumulator's precision.
#pragma once

#include <cuda_bf16.h>

namespace repro {

using bf16 = __nv_bfloat16;

template <typename Acc>
struct Num;

template <>
struct Num<double> {
  using R = double;
  static __device__ __forceinline__ R fma(R a, R b, R c) {
    return ::fma(a, b, c);
  }
  static __device__ __forceinline__ R cadd(R a, R b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ R round(R a) { return a; }
  static __device__ __forceinline__ R add(R a, R b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ R sub(R a, R b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ R mul(R a, R b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ R from_double(double v) { return v; }
};

template <>
struct Num<float> {
  using R = float;
  static __device__ __forceinline__ R fma(R a, R b, R c) {
    return fmaf(a, b, c);
  }
  static __device__ __forceinline__ R cadd(R a, R b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ R round(R a) { return a; }
  static __device__ __forceinline__ R add(R a, R b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ R sub(R a, R b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ R mul(R a, R b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ R from_double(double v) {
    return __double2float_rn(v);
  }
};

template <>
struct Num<bf16> {
  using R = float;
  static __device__ __forceinline__ R fma(R a, R b, R c) {
    return fmaf(a, b, c);
  }
  static __device__ __forceinline__ R cadd(R a, R b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ R round(R a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
  static __device__ __forceinline__ R add(R a, R b) {
    return round(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ R sub(R a, R b) {
    return round(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ R mul(R a, R b) {
    return round(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ R from_double(double v) {
    return __bfloat162float(__double2bfloat16(v));
  }
};

// A payload type: W its register type (every T widens to W exactly),
// P two neighbouring elements as one load or store (16 bytes at f64, 8 at
// f32, 4 at bf16; the address must be aligned to the pair), `narrow`
// rounds a register value to T (to nearest).
template <typename T>
struct Elem;

template <>
struct Elem<double> {
  using W = double;
  using P = double2;
  static __device__ __forceinline__ W widen(double v) { return v; }
  static __device__ __forceinline__ double narrow(W v) { return v; }
  static __device__ __forceinline__ P pair(W a, W b) {
    return make_double2(a, b);
  }
};

template <>
struct Elem<float> {
  using W = float;
  using P = float2;
  static __device__ __forceinline__ W widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(W v) { return v; }
  static __device__ __forceinline__ P pair(W a, W b) {
    return make_float2(a, b);
  }
};

template <>
struct Elem<bf16> {
  using W = float;
  using P = __nv_bfloat162;
  static __device__ __forceinline__ W widen(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 narrow(W v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ P pair(W a, W b) {
    return __floats2bfloat162_rn(a, b);
  }
};

template <typename T>
__device__ __forceinline__ typename Elem<T>::W widen(T v) {
  return Elem<T>::widen(v);
}

template <typename T, typename R>
__device__ __forceinline__ T narrow(R v) {
  return Elem<T>::narrow(v);
}

// Payloads read as pairs must start aligned to the pair.
template <typename T>
inline bool pair_aligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % (2 * sizeof(T)) == 0;
}

}  // namespace repro
