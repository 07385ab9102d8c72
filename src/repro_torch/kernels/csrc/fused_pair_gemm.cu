// fused_pair_gemm — the Galerkin numeric product over the tiled
// (ELL-of-pairs) SpGEMM plan, on Hopper:
//   out[row] = sum over valid slots k of A[ta[row,k]] @ B[tb[row,k]].
//
// Replaces the TPU kernel repro/kernels/fused_pair_gemm/fused_pair_gemm.py
// (fused_pair_gemm / _fused_kernel).  As there, the (npairs, br, bc)
// pair-product array is never built; unlike the TPU path, the A and B
// blocks are gathered inside the kernel through the plan's tile_pair_a/b
// and tile_mask, so the gathered operand arrays of the reference's
// _fused_numeric are never built either.  The output is one partial block
// per tile row; rows of one output slot (tile_identity False) are combined
// by block_seg_sum.
//
// Bound: bytes — each valid pair's A block and B block are read (gathers),
// plus the int32 plan and the mask, and one output block per tile row.
// 2*br*bk*bc flops per pair stay far below the fp64 balance, and the
// tensor cores do not apply: DMMA sums in its own order, and 3- or 6-wide
// blocks fill none of its shapes.
//
// Design.  A CTA owns `R` consecutive tile rows (never a part of one: the
// combine is block_seg_sum's job); thread (row r, output row i) keeps the
// `BC` sums of its strip in registers, so it reads its A row once per
// pair and the row's BR threads share each B block.
//   1. The CTA's mask / tile_pair_a / tile_pair_b are read once, coalesced
//      (its rows are one contiguous run of the plan), into shared memory,
//      with the min / max of the valid lhs indices.
//   2. The lhs: the tile rows of one output block row all read lhs blocks
//      of one CSR row of the lhs, a contiguous range of `a`.  When the
//      CTA's [min, max] range fits its area, it is copied once with
//      cp.async and every pair reads its A row from there.
//   3. The pairs.  Rows of at most kDirectMaxK slots (all but the coarsest
//      R(AP)): each warp owns 32 / BR rows and streams their B blocks
//      through its own shared buffer, slot by slot — the BR lanes of a row
//      load its block in 16-byte pieces (a few wide loads a lane instead of
//      every lane loading the whole block), and the next slot's pieces are
//      in flight while this slot is multiplied; no CTA barrier follows the
//      plan.  A rows come from the staged range or as 16-byte loads.
//      Longer rows go through a ring of 2..8 shared-memory stages of C
//      slots per row, filled by cp.async while the threads multiply an
//      earlier stage: such a launch has few rows (2 a CTA, to spread over
//      ~2 CTAs an SM), so its threads alone could not keep enough gathers
//      in flight.  On the m=32 cases each path is the faster one on its
//      side of kDirectMaxK.
// Copies and loads take two elements at once where a block's size and
// the base pointer allow it (6x6 and 6x3 / 3x6 blocks) and one otherwise
// (3x3 lhs blocks start at odd indices): 16 or 8 bytes at f64, 8 or 4 at
// f32, 4 or 2 at bf16 (cp.async copies 4 bytes at least, so a single bf16
// element is copied by a plain load and store).
//
// Shapes: (3,3,6), (6,3,6), (6,6,6), and (1,1,1) for the scalar (AIJ)
// baseline's PtAP chain (core/scalar_path.py): there a thread owns one
// scalar tile row, a warp 32 of them, and every copy is one element.
//
// Bits: every output element is one fma chain in the order of the first,
// thread-per-element kernel — valid slots ascending (masked slots
// skipped), then j = 0..BK-1, from 0.0 — whatever `threads`, the geometry,
// the path or the lhs mode, so the card's coarse operators do not move by
// one bit.  A row whose slots are all masked writes an exact 0.0.
//
// Payloads: f64, f32 and bf16 (repro_fused_pair_gemm_{f64,f32,bf16}), at
// the reference's accumulator rule (num.cuh): the chain runs at f64, f32
// and f32 (bf16 operands widened on-register) and the strip is rounded
// once to the payload type.  The shared-memory areas are budgets in
// bytes, so a narrower payload stages more blocks in the same area.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "num.cuh"

namespace {

constexpr int kDirectMaxK = 32;           // longer rows take the ring
constexpr int kRangeBytes = 16 * 1024;    // lhs range area (direct path)
constexpr int kIdxCap = 1024;             // staged index slots (ring path)
constexpr int kOperandBytes = 48 * 1024;  // lhs range + ring (ring path)
constexpr int kMaxDepth = 8;              // ring stages

// The geometry of one launch: derived from `threads`, the shape, the
// payload's size and the card's SM count only, so every launch of a
// signature has one geometry.
struct Plan {
  bool direct;
  int rows_per_cta, window, chunk;
  size_t smem;
};

template <int BR, int BK, int BC, typename T>
Plan plan_for(int rows, int kmax, int threads, int sms) {
  constexpr int UNIT = sizeof(T) * (BR * BK + BK * BC);   // bytes of a pair
  Plan p{};
  p.direct = kmax <= kDirectMaxK;
  // one strip per thread; few tile rows take fewer rows per CTA, so the
  // launch still spreads over ~2 CTAs an SM
  int r = threads / BR;
  const int spread = rows / (2 * (sms > 0 ? sms : 1));
  if (spread < r) r = spread > 1 ? spread : 1;
  if (p.direct) {
    // 32 / BR rows a warp
    const int warp_rows = (threads / 32) * (32 / BR);
    if (warp_rows < r) r = warp_rows;
    p.rows_per_cta = r;
    p.window = kmax > 1 ? kmax : 1;
    p.smem = kRangeBytes + sizeof(T) * static_cast<size_t>(threads / 32) *
                               (32 / BR) * BK * BC +
             sizeof(int) * 2 * static_cast<size_t>(r) * p.window;
    return p;
  }
  // ring: an unstaged stage takes at most half the operand area
  const int cap = kOperandBytes / (2 * UNIT);
  if (cap < r) r = cap;
  p.rows_per_cta = r;
  const int w = kIdxCap / r;
  p.window = kmax < w ? kmax : w;
  const int c = kOperandBytes / (4 * UNIT * r);
  p.chunk = c < 1 ? 1 : (c < p.window ? c : p.window);
  p.smem = kOperandBytes + sizeof(int) * 2 * static_cast<size_t>(r) *
                               p.window;
  return p;
}

template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES));
}

// One copy of two elements (`wide`) or one into shared memory: cp.async
// where it is 4 bytes or more, a plain load and store for one bf16.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool wide) {
  constexpr int B = sizeof(T);
  if (wide) {
    cp_async_n<2 * B>(dst, src);
  } else if constexpr (B >= 4) {
    cp_async_n<B>(dst, src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most `n` (0..kMaxDepth-2) groups are pending
__device__ __forceinline__ void cp_wait_pending(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    default: cp_wait<6>(); break;
  }
}

// Slots [w0, w0 + wn) of rows [r0, r0 + nr) into sa (lhs index, or -1 on a
// masked slot) and sb, row stride W; returns the CTA's min / max of the
// valid lhs indices (every thread gets them).
__device__ __forceinline__ int2 load_plan(
    const int* __restrict__ ta, const int* __restrict__ tb,
    const unsigned char* __restrict__ mask, int* sa, int* sb, long long r0,
    int nr, int kmax, int w0, int wn, int W, int* s_lo, int* s_hi) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    *s_lo = INT_MAX;
    *s_hi = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int e = tid; e < nr * wn; e += nt) {
    const int rr = e / wn, c = e - rr * wn;
    const long long g = (r0 + rr) * kmax + w0 + c;
    const unsigned char m = mask[g];
    const int av = ta[g], bv = tb[g];
    sa[rr * W + c] = m ? av : -1;
    sb[rr * W + c] = bv;
    if (m) {
      lo = min(lo, av);
      hi = max(hi, av);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((tid & 31) == 0) {
    atomicMin(s_lo, lo);
    atomicMax(s_hi, hi);
  }
  __syncthreads();
  return make_int2(*s_lo, *s_hi);
}

// Copy lhs blocks [lo, hi] to `dst`; returns the elements taken (rounded
// up to an even count, to keep what follows aligned to a pair).
template <int A_N, typename T>
__device__ __forceinline__ int stage_range(const T* __restrict__ a, T* dst,
                                           int lo, int hi, bool wide) {
  const int ua = wide ? 2 : 1;
  const int n = (hi - lo + 1) * (A_N / ua);
  const T* src = a + static_cast<long long>(lo) * A_N;
  for (int v = threadIdx.x; v < n; v += blockDim.x)
    cp_async(dst + v * ua, src + v * ua, wide);
  const int used = (hi - lo + 1) * A_N;
  return used + (used & 1);
}

// acc[l] = fma(A[i][j], B[j][l], acc[l]) for j = 0..BK-1 in order at the
// payload's register type: `ar` is the A row, `bb` the B block, each in
// global or shared memory and read as pairs where `wide_a` / `wide_b`.
template <int BK, int BC, typename T>
__device__ __forceinline__ void strip_fma(typename repro::Elem<T>::W (&acc)[BC],
                                          const T* ar, const T* bb,
                                          bool wide_a, bool wide_b) {
  using W = typename repro::Elem<T>::W;
  using P = typename repro::Elem<T>::P;
  using N = repro::Num<W>;
  W av[BK];
  if (BK % 2 == 0 && wide_a) {
#pragma unroll
    for (int j = 0; j < BK; j += 2) {
      const P v = *reinterpret_cast<const P*>(ar + j);
      av[j] = repro::widen(v.x);
      av[j + 1] = repro::widen(v.y);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK; ++j) av[j] = repro::widen(ar[j]);
  }
  if (BC % 2 == 0 && wide_b) {
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const P* bj = reinterpret_cast<const P*>(bb + j * BC);
#pragma unroll
      for (int q = 0; q < BC / 2; ++q) {
        const P v = bj[q];
        acc[2 * q] = N::fma(av[j], repro::widen(v.x), acc[2 * q]);
        acc[2 * q + 1] = N::fma(av[j], repro::widen(v.y), acc[2 * q + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK; ++j)
#pragma unroll
      for (int l = 0; l < BC; ++l)
        acc[l] = N::fma(av[j], repro::widen(bb[j * BC + l]), acc[l]);
  }
}

// The strip rounded to the payload type, in pair stores (`out` comes from
// the wrapper's allocation, aligned to a pair, and a strip starts at a
// multiple of BC = 6 elements).
template <int BR, int BC, typename T>
__device__ __forceinline__ void store_strip(
    T* __restrict__ out, long long row, int i,
    const typename repro::Elem<T>::W (&acc)[BC]) {
  using E = repro::Elem<T>;
  T* o = out + (row * BR + i) * BC;
  if constexpr (BC % 2 == 0) {
#pragma unroll
    for (int l = 0; l < BC; l += 2)
      *reinterpret_cast<typename E::P*>(o + l) = E::pair(acc[l], acc[l + 1]);
  } else {
#pragma unroll
    for (int l = 0; l < BC; ++l) o[l] = E::narrow(acc[l]);
  }
}

// One warp's rows of the direct path, slot by slot: the BR lanes of a row
// copy its B block in chunks of C (two elements or one) into the warp's
// buffer `wb`, the next slot's chunks are loaded into registers while this
// slot is multiplied.  `live`: the lane owns a row of the launch.
template <typename C, int BR, int BK, int BC, typename T>
__device__ __forceinline__ void direct_rows(
    const T* __restrict__ a, const T* __restrict__ b, const int* sa,
    const int* sb, const T* range, int range_lo, bool ranged, T* wb, int r,
    int i, bool live, int kmax, bool wide_a,
    typename repro::Elem<T>::W (&acc)[BC]) {
  constexpr int A_N = BR * BK, B_N = BK * BC;
  constexpr int U = sizeof(C) / sizeof(T);        // elements per chunk
  constexpr int NCH = B_N / U;                    // chunks per block
  constexpr int CPL = (NCH + BR - 1) / BR;        // chunks per lane
  C next[CPL];
  auto fetch = [&](int k) {
    if (!live || sa[r * kmax + k] < 0) return;
    const C* src = reinterpret_cast<const C*>(
        b + static_cast<long long>(sb[r * kmax + k]) * B_N);
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (i + c * BR < NCH) next[c] = src[i + c * BR];
  };
  fetch(0);
  for (int k = 0; k < kmax; ++k) {
    const int av = live ? sa[r * kmax + k] : -1;
    __syncwarp();                       // the warp is done with slot k-1
    if (av >= 0) {
      C* dst = reinterpret_cast<C*>(wb);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (i + c * BR < NCH) dst[i + c * BR] = next[c];
    }
    __syncwarp();                       // the row's block is in `wb`
    if (k + 1 < kmax) fetch(k + 1);
    if (av >= 0) {
      const T* ar = (ranged ? range + (av - range_lo) * A_N
                            : a + static_cast<long long>(av) * A_N) + i * BK;
      strip_fma<BK, BC, T>(acc, ar, wb, wide_a, true);
    }
  }
}

// Rows of at most kDirectMaxK slots: the plan and the lhs range in shared
// memory; each warp owns 32 / BR rows and streams their B blocks through
// its own buffer (no CTA barrier after the plan is read).
template <int BR, int BK, int BC, typename T>
__global__ void __launch_bounds__(1024) pair_gemm_direct(
    const T* __restrict__ a, const T* __restrict__ b,
    const int* __restrict__ ta, const int* __restrict__ tb,
    const unsigned char* __restrict__ mask, T* __restrict__ out, int rows,
    int kmax, int R, bool wide_a, bool wide_b) {
  using W = typename repro::Elem<T>::W;
  using P = typename repro::Elem<T>::P;
  constexpr int A_N = BR * BK, B_N = BK * BC;
  constexpr int RANGE_N = kRangeBytes / sizeof(T);
  constexpr int G = 32 / BR;                      // rows per warp
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ int s_lo, s_hi;
  T* range = reinterpret_cast<T*>(smem_bytes);
  T* wbuf = range + RANGE_N;                      // G blocks per warp
  int* sa = reinterpret_cast<int*>(wbuf + (blockDim.x / 32) * G * B_N);
  int* sb = sa + R * kmax;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R), rows - r0));
  const int r = warp * G + lane / BR, i = lane % BR;
  const bool live = lane < G * BR && r < nr;
  W acc[BC];
#pragma unroll
  for (int l = 0; l < BC; ++l) acc[l] = W(0);
  const int2 lh = load_plan(ta, tb, mask, sa, sb, r0, nr, kmax, 0, kmax,
                            kmax, &s_lo, &s_hi);
  const bool ranged = lh.y >= lh.x &&
      static_cast<long long>(lh.y - lh.x + 1) * A_N <= RANGE_N;
  if (ranged) {
    stage_range<A_N, T>(a, range, lh.x, lh.y, wide_a);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
  if (warp * G >= nr) return;           // the warp owns no row
  T* wb = wbuf + (warp * G + lane / BR) * B_N;
  // an odd-sized B block (1x1) is never read in pairs
  bool paired = false;
  if constexpr (B_N % 2 == 0) {
    if (wide_b) {
      direct_rows<P, BR, BK, BC, T>(a, b, sa, sb, range, lh.x, ranged, wb, r,
                                    i, live, kmax, wide_a, acc);
      paired = true;
    }
  }
  if (!paired)
    direct_rows<T, BR, BK, BC, T>(a, b, sa, sb, range, lh.x, ranged, wb, r,
                                  i, live, kmax, wide_a, acc);
  if (live) store_strip<BR, BC, T>(out, r0 + r, i, acc);
}

// Rows of more than kDirectMaxK slots: windows of W slots, each through a
// ring of cp.async stages of C slots per row.
template <int BR, int BK, int BC, typename T>
__global__ void __launch_bounds__(1024) pair_gemm_ring(
    const T* __restrict__ a, const T* __restrict__ b,
    const int* __restrict__ ta, const int* __restrict__ tb,
    const unsigned char* __restrict__ mask, T* __restrict__ out, int rows,
    int kmax, int R, int W, int C, bool wide_a, bool wide_b) {
  using Wt = typename repro::Elem<T>::W;
  constexpr int A_N = BR * BK, B_N = BK * BC;
  constexpr int Q_N = kOperandBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  __shared__ int s_lo, s_hi;
  const int S = R * C;                        // slots per stage
  T* area = reinterpret_cast<T*>(smem_bytes); // lhs range, then the ring
  int* sa = reinterpret_cast<int*>(area + Q_N);
  int* sb = sa + R * W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R), rows - r0));
  const int r = tid / BR, i = tid - (tid / BR) * BR;
  const bool owner = r < nr;
  const int ua = wide_a ? 2 : 1, ub = wide_b ? 2 : 1;   // elements a copy
  const int na = A_N / ua, nb = B_N / ub;                // copies a block
  Wt acc[BC];
#pragma unroll
  for (int l = 0; l < BC; ++l) acc[l] = Wt(0);

  for (int w0 = 0; w0 < kmax; w0 += W) {
    const int wn = min(W, kmax - w0);
    const int2 lh = load_plan(ta, tb, mask, sa, sb, r0, nr, kmax, w0, wn, W,
                              &s_lo, &s_hi);
    // the lhs range, when it leaves room for two stages of B blocks
    const bool ranged = lh.y >= lh.x &&
        static_cast<long long>(lh.y - lh.x + 1) * A_N <=
            Q_N - 2 * (S * B_N + 1);
    const int used =
        ranged ? stage_range<A_N, T>(a, area, lh.x, lh.y, wide_a) : 0;
    cp_commit();
    // the ring: stage p holds S B blocks, then (unranged) S A blocks
    int stage_n = S * (B_N + (ranged ? 0 : A_N));
    stage_n += stage_n & 1;
    const int nc = (wn + C - 1) / C;
    const int depth = min(kMaxDepth, (Q_N - used) / stage_n);  // >= 2
    T* ring = area + used;
    auto fill = [&](int n) {
      if (n >= nc) return;
      const int k0 = n * C;
      T* db = ring + (n % depth) * stage_n;
      for (int v = tid; v < S * nb; v += nt) {
        const int e = v / nb, q = v - e * nb;
        const int rr = e / C, k = k0 + e - rr * C;
        if (rr >= nr || k >= wn) continue;
        const int x = rr * W + k;
        if (sa[x] < 0) continue;
        cp_async(db + e * B_N + q * ub,
                 b + static_cast<long long>(sb[x]) * B_N + q * ub, wide_b);
      }
      if (ranged) return;
      T* da = db + S * B_N;
      for (int v = tid; v < S * na; v += nt) {
        const int e = v / na, q = v - e * na;
        const int rr = e / C, k = k0 + e - rr * C;
        if (rr >= nr || k >= wn) continue;
        const int av = sa[rr * W + k];
        if (av < 0) continue;
        cp_async(da + e * A_N + q * ua,
                 a + static_cast<long long>(av) * A_N + q * ua, wide_a);
      }
    };
    for (int n = 0; n + 1 < depth; ++n) {
      fill(n);
      cp_commit();
    }
    for (int n = 0; n < nc; ++n) {
      // stage n (and the range) landed; every thread is past stage n-1's
      // products, so its ring slot takes stage n + depth - 1
      cp_wait_pending(depth - 2);
      __syncthreads();
      fill(n + depth - 1);
      cp_commit();
      if (owner) {
        const int k0 = n * C;
        const int cend = min(C, wn - k0);
        const T* db = ring + (n % depth) * stage_n;
        for (int c = 0; c < cend; ++c) {
          const int av = sa[r * W + k0 + c];
          if (av < 0) continue;
          const int e = r * C + c;
          const T* ar = (ranged ? area + (av - lh.x) * A_N
                                : db + S * B_N + e * A_N) + i * BK;
          strip_fma<BK, BC, T>(acc, ar, db + e * B_N, wide_a, true);
        }
      }
    }
  }
  if (owner) store_strip<BR, BC, T>(out, r0 + r, i, acc);
}

template <int BR, int BK, int BC, typename T>
int launch(const T* a, const T* b, const int* ta, const int* tb,
           const unsigned char* mask, T* out, int rows, int kmax,
           int threads, cudaStream_t stream) {
  if (rows <= 0) return repro::last_error();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Plan p = plan_for<BR, BK, BC, T>(rows, kmax, threads, sms);
  const bool wide_a = (BR * BK) % 2 == 0 && repro::pair_aligned<T>(a);
  const bool wide_b = (BK * BC) % 2 == 0 && repro::pair_aligned<T>(b);
  const unsigned grid = repro::blocks_for(rows, p.rows_per_cta);
  const int smem = static_cast<int>(p.smem);
  repro::note_launch(grid, threads);
  if (p.direct) {
    auto kern = pair_gemm_direct<BR, BK, BC, T>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<grid, threads, smem, stream>>>(a, b, ta, tb, mask, out, rows,
                                          kmax, p.rows_per_cta, wide_a,
                                          wide_b);
  } else {
    auto kern = pair_gemm_ring<BR, BK, BC, T>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<grid, threads, smem, stream>>>(a, b, ta, tb, mask, out, rows,
                                          kmax, p.rows_per_cta, p.window,
                                          p.chunk, wide_a, wide_b);
  }
  return repro::last_error();
}

template <typename T>
int entry(const void* a, const void* b, const void* tile_a,
          const void* tile_b, const void* tile_mask, void* out, int rows,
          int kmax, int br, int bk, int bc, int threads, void* stream) {
  auto av = static_cast<const T*>(a);
  auto bv = static_cast<const T*>(b);
  auto ta = static_cast<const int*>(tile_a);
  auto tb = static_cast<const int*>(tile_b);
  auto m = static_cast<const unsigned char*>(tile_mask);
  auto o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads;
  if (!repro::threads_ok(t)) return repro::bad_shape();
  // the strips are written as pairs
  if (!repro::pair_aligned<T>(out)) return repro::bad_shape();
  if (br == 3 && bk == 3 && bc == 6)
    return launch<3, 3, 6, T>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 6 && bk == 3 && bc == 6)
    return launch<6, 3, 6, T>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 6 && bk == 6 && bc == 6)
    return launch<6, 6, 6, T>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 1 && bk == 1 && bc == 1)
    return launch<1, 1, 1, T>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  return repro::bad_shape();
}

}  // namespace

#define REPRO_FUSED_PAIR_GEMM_ENTRY(SUFFIX, T)                               \
  REPRO_API int repro_fused_pair_gemm_##SUFFIX(                              \
      const void* a, const void* b, const void* tile_a, const void* tile_b,  \
      const void* tile_mask, void* out, int rows, int kmax, int br, int bk,  \
      int bc, int threads, void* stream) {                                   \
    return entry<T>(a, b, tile_a, tile_b, tile_mask, out, rows, kmax, br,    \
                    bk, bc, threads, stream);                                \
  }

REPRO_FUSED_PAIR_GEMM_ENTRY(f64, double)
REPRO_FUSED_PAIR_GEMM_ENTRY(f32, float)
REPRO_FUSED_PAIR_GEMM_ENTRY(bf16, repro::bf16)
