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
// Copies and loads are 16 bytes where a block's size and the base pointer
// allow it (6x6 and 6x3 / 3x6 blocks) and 8 bytes otherwise (3x3 lhs
// blocks start 8-byte aligned at odd indices).
//
// Bits: every output element is one fma chain in the order of the first,
// thread-per-element kernel — valid slots ascending (masked slots
// skipped), then j = 0..BK-1, from 0.0 — whatever `threads`, the geometry,
// the path or the lhs mode, so the card's coarse operators do not move by
// one bit.  A row whose slots are all masked writes an exact 0.0.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kDirectMaxK = 32;           // longer rows take the ring
constexpr int kRangeBytes = 16 * 1024;    // lhs range area (direct path)
constexpr int kIdxCap = 1024;             // staged index slots (ring path)
constexpr int kOperandBytes = 48 * 1024;  // lhs range + ring (ring path)
constexpr int kMaxDepth = 8;              // ring stages

// The geometry of one launch: derived from `threads`, the shape and the
// card's SM count only, so every launch of a signature has one geometry.
struct Plan {
  bool direct;
  int rows_per_cta, window, chunk;
  size_t smem;
};

template <int BR, int BK, int BC>
Plan plan_for(int rows, int kmax, int threads, int sms) {
  constexpr int UNIT = 8 * (BR * BK + BK * BC);   // bytes of one pair
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
    p.smem = kRangeBytes + 8 * static_cast<size_t>(threads / 32) *
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

__device__ __forceinline__ void cp_async(double* dst, const double* src,
                                         bool wide) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (wide)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
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

// Copy lhs blocks [lo, hi] to `dst`; returns the doubles taken (rounded up
// to keep what follows 16-byte aligned).
template <int A_DBL>
__device__ __forceinline__ int stage_range(const double* __restrict__ a,
                                           double* dst, int lo, int hi,
                                           bool wide) {
  const int ua = wide ? 2 : 1;
  const int n = (hi - lo + 1) * (A_DBL / ua);
  const double* src = a + static_cast<long long>(lo) * A_DBL;
  for (int v = threadIdx.x; v < n; v += blockDim.x)
    cp_async(dst + v * ua, src + v * ua, wide);
  const int used = (hi - lo + 1) * A_DBL;
  return used + (used & 1);
}

// acc[l] = fma(A[i][j], B[j][l], acc[l]) for j = 0..BK-1 in order: `ar` is
// the A row, `bb` the B block, each in global or shared memory and read
// as 16-byte pairs where `wide_a` / `wide_b`.
template <int BK, int BC>
__device__ __forceinline__ void strip_fma(double (&acc)[BC],
                                          const double* ar,
                                          const double* bb, bool wide_a,
                                          bool wide_b) {
  double av[BK];
  if (BK % 2 == 0 && wide_a) {
#pragma unroll
    for (int j = 0; j < BK; j += 2) {
      const double2 v = *reinterpret_cast<const double2*>(ar + j);
      av[j] = v.x;
      av[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK; ++j) av[j] = ar[j];
  }
  if (BC % 2 == 0 && wide_b) {
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const double2* bj = reinterpret_cast<const double2*>(bb + j * BC);
#pragma unroll
      for (int q = 0; q < BC / 2; ++q) {
        const double2 v = bj[q];
        acc[2 * q] = fma(av[j], v.x, acc[2 * q]);
        acc[2 * q + 1] = fma(av[j], v.y, acc[2 * q + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK; ++j)
#pragma unroll
      for (int l = 0; l < BC; ++l)
        acc[l] = fma(av[j], bb[j * BC + l], acc[l]);
  }
}

// The strip in 16-byte stores (`out` comes from the wrapper's allocation,
// and a strip starts at a multiple of BC = 6 doubles).
template <int BR, int BC>
__device__ __forceinline__ void store_strip(double* __restrict__ out,
                                            long long row, int i,
                                            const double (&acc)[BC]) {
  double* o = out + (row * BR + i) * BC;
  if constexpr (BC % 2 == 0) {
#pragma unroll
    for (int l = 0; l < BC; l += 2)
      *reinterpret_cast<double2*>(o + l) = make_double2(acc[l], acc[l + 1]);
  } else {
#pragma unroll
    for (int l = 0; l < BC; ++l) o[l] = acc[l];
  }
}

// One warp's rows of the direct path, slot by slot: the BR lanes of a row
// copy its B block in chunks of T (16 or 8 bytes) into the warp's buffer
// `wb`, the next slot's chunks are loaded into registers while this slot
// is multiplied.  `live`: the lane owns a row of the launch.
template <typename T, int BR, int BK, int BC>
__device__ __forceinline__ void direct_rows(
    const double* __restrict__ a, const double* __restrict__ b,
    const int* sa, const int* sb, const double* range, int range_lo,
    bool ranged, double* wb, int r, int i, bool live, int kmax,
    bool wide_a, double (&acc)[BC]) {
  constexpr int A_DBL = BR * BK, B_DBL = BK * BC;
  constexpr int U = sizeof(T) / sizeof(double);   // doubles per chunk
  constexpr int NCH = B_DBL / U;                  // chunks per block
  constexpr int CPL = (NCH + BR - 1) / BR;        // chunks per lane
  T next[CPL];
  auto fetch = [&](int k) {
    if (!live || sa[r * kmax + k] < 0) return;
    const T* src = reinterpret_cast<const T*>(
        b + static_cast<long long>(sb[r * kmax + k]) * B_DBL);
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (i + c * BR < NCH) next[c] = src[i + c * BR];
  };
  fetch(0);
  for (int k = 0; k < kmax; ++k) {
    const int av = live ? sa[r * kmax + k] : -1;
    __syncwarp();                       // the warp is done with slot k-1
    if (av >= 0) {
      T* dst = reinterpret_cast<T*>(wb);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (i + c * BR < NCH) dst[i + c * BR] = next[c];
    }
    __syncwarp();                       // the row's block is in `wb`
    if (k + 1 < kmax) fetch(k + 1);
    if (av >= 0) {
      const double* ar =
          (ranged ? range + (av - range_lo) * A_DBL
                  : a + static_cast<long long>(av) * A_DBL) + i * BK;
      strip_fma<BK, BC>(acc, ar, wb, wide_a, true);
    }
  }
}

// Rows of at most kDirectMaxK slots: the plan and the lhs range in shared
// memory; each warp owns 32 / BR rows and streams their B blocks through
// its own buffer (no CTA barrier after the plan is read).
template <int BR, int BK, int BC>
__global__ void __launch_bounds__(1024) pair_gemm_direct(
    const double* __restrict__ a, const double* __restrict__ b,
    const int* __restrict__ ta, const int* __restrict__ tb,
    const unsigned char* __restrict__ mask, double* __restrict__ out,
    int rows, int kmax, int R, bool wide_a, bool wide_b) {
  constexpr int A_DBL = BR * BK, B_DBL = BK * BC;
  constexpr int RANGE_DBL = kRangeBytes / 8;
  constexpr int G = 32 / BR;                      // rows per warp
  extern __shared__ __align__(16) double smem[];
  __shared__ int s_lo, s_hi;
  double* range = smem;
  double* wbuf = smem + RANGE_DBL;                // G blocks per warp
  int* sa = reinterpret_cast<int*>(wbuf + (blockDim.x / 32) * G * B_DBL);
  int* sb = sa + R * kmax;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R), rows - r0));
  const int r = warp * G + lane / BR, i = lane % BR;
  const bool live = lane < G * BR && r < nr;
  double acc[BC];
#pragma unroll
  for (int l = 0; l < BC; ++l) acc[l] = 0.0;
  const int2 lh = load_plan(ta, tb, mask, sa, sb, r0, nr, kmax, 0, kmax,
                            kmax, &s_lo, &s_hi);
  const bool ranged = lh.y >= lh.x &&
      static_cast<long long>(lh.y - lh.x + 1) * A_DBL <= RANGE_DBL;
  if (ranged) {
    stage_range<A_DBL>(a, range, lh.x, lh.y, wide_a);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }
  if (warp * G >= nr) return;           // the warp owns no row
  double* wb = wbuf + (warp * G + lane / BR) * B_DBL;
  if (wide_b)
    direct_rows<double2, BR, BK, BC>(a, b, sa, sb, range, lh.x, ranged, wb,
                                     r, i, live, kmax, wide_a, acc);
  else
    direct_rows<double, BR, BK, BC>(a, b, sa, sb, range, lh.x, ranged, wb,
                                    r, i, live, kmax, wide_a, acc);
  if (live) store_strip<BR, BC>(out, r0 + r, i, acc);
}

// Rows of more than kDirectMaxK slots: windows of W slots, each through a
// ring of cp.async stages of C slots per row.
template <int BR, int BK, int BC>
__global__ void __launch_bounds__(1024) pair_gemm_ring(
    const double* __restrict__ a, const double* __restrict__ b,
    const int* __restrict__ ta, const int* __restrict__ tb,
    const unsigned char* __restrict__ mask, double* __restrict__ out,
    int rows, int kmax, int R, int W, int C, bool wide_a, bool wide_b) {
  constexpr int A_DBL = BR * BK, B_DBL = BK * BC;
  constexpr int Q_DBL = kOperandBytes / 8;
  extern __shared__ __align__(16) double smem[];
  __shared__ int s_lo, s_hi;
  const int S = R * C;                        // slots per stage
  double* area = smem;                        // lhs range, then the ring
  int* sa = reinterpret_cast<int*>(smem + Q_DBL);
  int* sb = sa + R * W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(min(static_cast<long long>(R), rows - r0));
  const int r = tid / BR, i = tid - (tid / BR) * BR;
  const bool owner = r < nr;
  const int ua = wide_a ? 2 : 1, ub = wide_b ? 2 : 1;   // doubles per copy
  const int na = A_DBL / ua, nb = B_DBL / ub;            // copies per block
  double acc[BC];
#pragma unroll
  for (int l = 0; l < BC; ++l) acc[l] = 0.0;

  for (int w0 = 0; w0 < kmax; w0 += W) {
    const int wn = min(W, kmax - w0);
    const int2 lh = load_plan(ta, tb, mask, sa, sb, r0, nr, kmax, w0, wn, W,
                              &s_lo, &s_hi);
    // the lhs range, when it leaves room for two stages of B blocks
    const bool ranged = lh.y >= lh.x &&
        static_cast<long long>(lh.y - lh.x + 1) * A_DBL <=
            Q_DBL - 2 * (S * B_DBL + 1);
    const int used =
        ranged ? stage_range<A_DBL>(a, area, lh.x, lh.y, wide_a) : 0;
    cp_commit();
    // the ring: stage p holds S B blocks, then (unranged) S A blocks
    int stage_dbl = S * (B_DBL + (ranged ? 0 : A_DBL));
    stage_dbl += stage_dbl & 1;
    const int nc = (wn + C - 1) / C;
    const int depth = min(kMaxDepth, (Q_DBL - used) / stage_dbl);  // >= 2
    double* ring = area + used;
    auto fill = [&](int n) {
      if (n >= nc) return;
      const int k0 = n * C;
      double* db = ring + (n % depth) * stage_dbl;
      for (int v = tid; v < S * nb; v += nt) {
        const int e = v / nb, q = v - e * nb;
        const int rr = e / C, k = k0 + e - rr * C;
        if (rr >= nr || k >= wn) continue;
        const int x = rr * W + k;
        if (sa[x] < 0) continue;
        cp_async(db + e * B_DBL + q * ub,
                 b + static_cast<long long>(sb[x]) * B_DBL + q * ub, wide_b);
      }
      if (ranged) return;
      double* da = db + S * B_DBL;
      for (int v = tid; v < S * na; v += nt) {
        const int e = v / na, q = v - e * na;
        const int rr = e / C, k = k0 + e - rr * C;
        if (rr >= nr || k >= wn) continue;
        const int av = sa[rr * W + k];
        if (av < 0) continue;
        cp_async(da + e * A_DBL + q * ua,
                 a + static_cast<long long>(av) * A_DBL + q * ua, wide_a);
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
        const double* db = ring + (n % depth) * stage_dbl;
        for (int c = 0; c < cend; ++c) {
          const int av = sa[r * W + k0 + c];
          if (av < 0) continue;
          const int e = r * C + c;
          const double* ar = (ranged ? area + (av - lh.x) * A_DBL
                                     : db + S * B_DBL + e * A_DBL) + i * BK;
          strip_fma<BK, BC>(acc, ar, db + e * B_DBL, wide_a, true);
        }
      }
    }
  }
  if (owner) store_strip<BR, BC>(out, r0 + r, i, acc);
}

template <int BR, int BK, int BC>
int launch(const double* a, const double* b, const int* ta, const int* tb,
           const unsigned char* mask, double* out, int rows, int kmax,
           int threads, cudaStream_t stream) {
  if (rows <= 0) return repro::last_error();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const Plan p = plan_for<BR, BK, BC>(rows, kmax, threads, sms);
  const bool wide_a = (BR * BK) % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool wide_b = (BK * BC) % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const unsigned grid = repro::blocks_for(rows, p.rows_per_cta);
  const int smem = static_cast<int>(p.smem);
  repro::note_launch(grid, threads);
  if (p.direct) {
    auto kern = pair_gemm_direct<BR, BK, BC>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<grid, threads, smem, stream>>>(a, b, ta, tb, mask, out, rows,
                                          kmax, p.rows_per_cta, wide_a,
                                          wide_b);
  } else {
    auto kern = pair_gemm_ring<BR, BK, BC>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kern<<<grid, threads, smem, stream>>>(a, b, ta, tb, mask, out, rows,
                                          kmax, p.rows_per_cta, p.window,
                                          p.chunk, wide_a, wide_b);
  }
  return repro::last_error();
}

}  // namespace

REPRO_API int repro_fused_pair_gemm_f64(const void* a, const void* b,
                                        const void* tile_a,
                                        const void* tile_b,
                                        const void* tile_mask, void* out,
                                        int rows, int kmax, int br, int bk,
                                        int bc, int threads,
                                        void* stream) {
  auto av = static_cast<const double*>(a);
  auto bv = static_cast<const double*>(b);
  auto ta = static_cast<const int*>(tile_a);
  auto tb = static_cast<const int*>(tile_b);
  auto m = static_cast<const unsigned char*>(tile_mask);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int t = threads;
  if (!repro::threads_ok(t)) return repro::bad_shape();
  // the strips are written as 16-byte pairs
  if (reinterpret_cast<uintptr_t>(out) % 16) return repro::bad_shape();
  if (br == 3 && bk == 3 && bc == 6)
    return launch<3, 3, 6>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 6 && bk == 3 && bc == 6)
    return launch<6, 3, 6>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  if (br == 6 && bk == 6 && bc == 6)
    return launch<6, 6, 6>(av, bv, ta, tb, m, o, rows, kmax, t, s);
  return repro::bad_shape();
}
