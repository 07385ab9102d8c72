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
// The staged body (6x6 panels, k > 1; the rule in launch() reads only the
// block size and k).  The sub-warp body's chunks of a row each load every
// block of it (KC = 4 at bs 6, so a 16-wide panel reads each 288-byte
// block four times through L1/L2) and walk all kmax slots, padding
// included (the 6x6 operators' ELLs are 57-89% full at m = 32 and 64);
// its lanes gather x from 32 different blocks a load.  Here a CTA owns
// `rows` whole block rows and copies each row's valid slots, `slots` at a
// time, into a ring of two shared-memory stages with cp.async of 16 bytes
// (8 at f32, 4 at bf16: the pair, the payloads' alignment), issuing the
// next stage's copy before the current stage's FMAs; the indices come in
// the same stages.
// The copy stops at the row's length (`lengths`, built with the ELL's
// structure; null: kmax), so the padded tail is never read.  A staged
// block takes bs*bs + 2 elements, so threads reading neighbouring slots
// fall on distinct banks.  An item (lane class l, chunk c of kStagedKC
// columns) sums what lane l of chunk c sums in the sub-warp body: slots
// l, l + lanes, ... in ascending order (`slots` is a multiple of `lanes`),
// now below the row's length, through the same ell_slot chain.  The
// chunks of a class are neighbouring threads, so a load instruction
// gathers a few x blocks, each in whole 128-byte lines, and each staged
// block is read from shared memory by every chunk.  The classes' sums
// meet in shared memory in lanes_sum's butterfly order, and the entries
// are finished as there.  The chain of one (a, j) depends neither on the
// chunk width nor on which thread runs it, and a skipped padded slot
// added an exact zero, so for finite inputs x', d' are bitwise the
// sub-warp body's.  cp.async over TMA bulk copies: the padded stride needs
// a copy per block either way, and bf16 blocks (72 bytes) are not the
// 16-byte multiples a bulk copy takes.  `threads` sets threads per CTA
// alone: a CTA takes as many rows as it has threads for their items (at
// least one; a row with more items than threads is taken in passes of
// column chunks, streaming it again for each, so the sums never outgrow
// the stages), its slots a stage are threads / kThreadsPerSlot within
// [32, kStageSlots].  kStagedKC, kThreadsPerSlot and kStagedMinBlocks come
// from CUDA-event timings on an H100 (PERF.md's kernel table): on rows as
// wide as level 2's, chunks of 1 or 4 columns were slower and 2 threads a
// slot no faster; on the m = 64 level-2 operator, register caps for 2 or
// 4 CTAs an SM were slower, and pair loads of x no faster.
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
#include <algorithm>

#include "ell_row.cuh"

namespace {

// The chunk's entries from its row sums acc (every lane holds them, after
// lanes_sum): lane l finishes the entries (a, j) with (a * KC + j) %
// lanes == l, res = b - A x, z = D^-1 res as an FMA chain over c
// ascending, then the recurrence with explicit roundings.
template <int BS, int KC, typename T, typename Acc>
__device__ __forceinline__ void finish_chunk(
    typename repro::Num<Acc>::R (&acc)[BS][KC], long long r, int c0,
    int ncol, int k, int lane, int lanes, const T* __restrict__ dinv,
    const T* __restrict__ b, const T* __restrict__ x,
    const T* __restrict__ d, const T* __restrict__ coef,
    T* __restrict__ x_out, T* __restrict__ d_out) {
  using N = repro::Num<Acc>;
  using R = typename N::R;
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

template <int BS, int KC, int MAXT, typename T, typename Acc>
__global__ void __launch_bounds__(MAXT) smoother_kernel(
    const int* __restrict__ idx, const T* __restrict__ data,
    const T* __restrict__ dinv, const T* __restrict__ b,
    const T* __restrict__ x, const T* __restrict__ d,
    const T* __restrict__ coef, T* __restrict__ x_out,
    T* __restrict__ d_out, int nbr, int kmax, int k, int lanes) {
  using R = typename repro::Num<Acc>::R;
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
  finish_chunk<BS, KC, T, Acc>(acc, r, c0, ncol, k, lane, lanes, dinv, b, x,
                               d, coef, x_out, d_out);
}

// Asynchronous copies global -> shared of BYTES (4, 8 or 16; both
// addresses aligned to it), in groups.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// slots of a stage, all of a CTA's rows together: one for every
// kThreadsPerSlot threads, within [32, kStageSlots]
constexpr int kStageSlots = 256;
constexpr int kThreadsPerSlot = 4;

// columns an item of the staged body sums (its chunk); any width gives
// the same chain for each (a, j)
constexpr int kStagedKC = 2;

// CTAs of at most 256 threads an SM should hold (the register cap of
// their build)
constexpr int kStagedMinBlocks = 3;

// elements of one staged block: bs * bs and one pair of padding
template <int BS>
__host__ __device__ constexpr int staged_stride() {
  return BS * BS + 2;
}

// The staged body's shared memory: `rows` lengths (16-byte aligned), two
// stages of `slots` blocks and indices a row, and a pass's sums, which
// take the stages' place once the pass has streamed its rows.
struct StagedLayout {
  size_t stage, index, bytes;
  __host__ __device__ StagedLayout(int rows, int slots, int items,
                                   size_t elem, size_t stride,
                                   size_t sum_bytes) {
    stage = (rows * sizeof(int) + 15) / 16 * 16;
    index = stage + 2 * static_cast<size_t>(rows) * slots * stride * elem;
    const size_t end = index + 2 * static_cast<size_t>(rows) * slots * 4;
    const size_t sums = stage + static_cast<size_t>(items) * sum_bytes;
    bytes = sums > end ? sums : end;
  }
};

// Chunks of a row a pass of the staged body takes: all of them when the
// CTA has a thread for every item of its rows, else (one row) as many as
// its threads hold for every lane class.
__host__ __device__ inline int staged_chunks(int threads, int rows,
                                             int lanes, int nchunk) {
  if (rows * lanes * nchunk <= threads) return nchunk;
  return threads / lanes;
}

// The staged body (see the header).  CTA b owns rows b * rows ...  A pass
// takes chunks c_lo ... c_lo + cg - 1 of them; thread t runs item t of
// the pass, (row * lanes + l) * cg + c - c_lo for lane class l and chunk
// c, so the chunks of one class sit on neighbouring threads and read
// neighbouring columns of the same x block.  Once the pass has streamed
// its rows through the stages, each item's sums go to shared memory, and
// there the lanes of a row meet in lanes_sum's xor butterfly as the same
// tree: at offset o = lanes / 2, ..., 1, class l < o adds class l + o
// (= l ^ o); then the pass's entries are finished.
template <int BS, int KC, int MAXT, int MINB, typename T, typename Acc>
__global__ void __launch_bounds__(MAXT, MINB) staged_smoother_kernel(
    const int* __restrict__ idx, const int* __restrict__ lengths,
    const T* __restrict__ data, const T* __restrict__ dinv,
    const T* __restrict__ b, const T* __restrict__ x,
    const T* __restrict__ d, const T* __restrict__ coef,
    T* __restrict__ x_out, T* __restrict__ d_out, int nbr, int kmax, int k,
    int lanes, int rows, int slots) {
  using N = repro::Num<Acc>;
  using R = typename N::R;
  using P = typename repro::Elem<T>::P;
  constexpr int NB = BS * BS;
  constexpr int NP = NB / 2;  // pairs of a block, the copy unit
  constexpr int STRIDE = staged_stride<BS>();
  constexpr int NE = BS * KC;  // sums of an item
  const int nchunk = (k + KC - 1) / KC;
  const int per_pass = staged_chunks(blockDim.x, rows, lanes, nchunk);
  const StagedLayout lay(rows, slots, rows * lanes * per_pass, sizeof(T),
                         STRIDE, NE * sizeof(R));
  extern __shared__ __align__(16) unsigned char smem[];
  int* slen = reinterpret_cast<int*>(smem);
  T* sblk = reinterpret_cast<T*>(smem + lay.stage);
  int* sidx = reinterpret_cast<int*>(smem + lay.index);
  R* sums = reinterpret_cast<R*>(smem + lay.stage);
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const long long ri = row0 + i;
    int n = 0;
    if (ri < nbr) n = lengths ? min(max(lengths[ri], 0), kmax) : kmax;
    slen[i] = n;
  }
  __syncthreads();
  int most = 0;
  for (int i = 0; i < rows; ++i) most = max(most, slen[i]);
  const int stages = (most + slots - 1) / slots;
  // stage st: slots st * slots ... of every row below its length, into
  // buffer st & 1; neighbouring threads copy neighbouring pairs of a row
  auto stage = [&](int st) {
    T* bb = sblk + (st & 1) * rows * slots * STRIDE;
    int* ib = sidx + (st & 1) * rows * slots;
    const int s0 = st * slots;
    for (int u = threadIdx.x; u < rows * slots * NP; u += blockDim.x) {
      const int q = u / NP, p = u - q * NP;
      const int i = q / slots, j = q - i * slots;
      if (s0 + j < slen[i])
        cp_async<static_cast<int>(sizeof(P))>(
            bb + q * STRIDE + 2 * p,
            data + ((row0 + i) * kmax + s0 + j) * NB + 2 * p);
    }
    for (int q = threadIdx.x; q < rows * slots; q += blockDim.x) {
      const int i = q / slots, j = q - i * slots;
      if (s0 + j < slen[i])
        cp_async<4>(ib + q, idx + (row0 + i) * kmax + s0 + j);
    }
    cp_async_commit();
  };
  for (int c_lo = 0; c_lo < nchunk; c_lo += per_pass) {
    const int cg = min(per_pass, nchunk - c_lo);
    const int items = rows * lanes * cg;
    const int item = threadIdx.x;
    const int lr = item / (lanes * cg);
    const int l = item / cg % lanes;
    const int c0 = (c_lo + item % cg) * KC;
    const int ncol = k - c0 < KC ? k - c0 : KC;
    const int len = item < items ? slen[lr] : 0;
    R acc[BS][KC];
#pragma unroll
    for (int a = 0; a < BS; ++a) {
#pragma unroll
      for (int j = 0; j < KC; ++j) acc[a][j] = R(0);
    }
    if (stages > 0) stage(0);
    for (int st = 0; st < stages; ++st) {
      if (st + 1 < stages) {
        stage(st + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // class l: the stage's slots l, l + lanes, ... of its row (slots is
      // a multiple of lanes, so the row's ascending order holds)
      const int end = min(slots, len - st * slots);
      const T* bb = sblk + ((st & 1) * rows + lr) * slots * STRIDE;
      const int* ib = sidx + ((st & 1) * rows + lr) * slots;
      for (int j = l; j < end; j += lanes)
        repro::ell_slot<BS, BS, KC, T, Acc>(
            bb + j * STRIDE, x + static_cast<long long>(ib[j]) * BS * k + c0,
            k, ncol, acc);
      __syncthreads();
    }
    if (item < items) {
#pragma unroll
      for (int a = 0; a < BS; ++a) {
#pragma unroll
        for (int j = 0; j < KC; ++j) sums[item * NE + a * KC + j] = acc[a][j];
      }
    }
    __syncthreads();
    // the butterfly's tree; a row's sums at class 0 then hold its A x
    const int chunk_sums = cg * NE;
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      for (int u = threadIdx.x; u < rows * o * chunk_sums; u += blockDim.x) {
        const int e = u % chunk_sums, q = u / chunk_sums;
        const int i = q / o, cl = q - i * o;
        R* v = sums + (i * lanes + cl) * chunk_sums + e;
        *v = N::cadd(*v, v[o * chunk_sums]);
      }
      __syncthreads();
    }
    if (item < items && row0 + lr < nbr) {
      const R* v = sums + (lr * lanes * cg + item % cg) * NE;
#pragma unroll
      for (int a = 0; a < BS; ++a) {
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[a][j] = v[a * KC + j];
      }
      finish_chunk<BS, KC, T, Acc>(acc, row0 + lr, c0, ncol, k, l, lanes,
                                   dinv, b, x, d, coef, x_out, d_out);
    }
    // the next pass's stages overwrite the sums
    __syncthreads();
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
  const int* lengths;  // the panel entry's; null: every row is kmax long
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

template <int BS, int MAXT, int MINB, typename T, typename Acc>
int launch_staged_at(const Args<T>& a, int rows, int slots) {
  constexpr int KC = kStagedKC;
  const int per_pass = staged_chunks(a.threads, rows, a.lanes,
                                     (a.k + KC - 1) / KC);
  const StagedLayout lay(rows, slots, rows * a.lanes * per_pass, sizeof(T),
                         staged_stride<BS>(),
                         BS * KC * sizeof(typename repro::Num<Acc>::R));
  const cudaError_t set = cudaFuncSetAttribute(
      staged_smoother_kernel<BS, KC, MAXT, MINB, T, Acc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(a.nbr) + rows - 1) / rows);
  repro::note_launch(blocks, a.threads);
  staged_smoother_kernel<BS, KC, MAXT, MINB, T, Acc>
      <<<blocks, a.threads, lay.bytes, a.stream>>>(
          a.idx, a.lengths, a.data, a.dinv, a.b, a.x, a.d, a.coef, a.x_out,
          a.d_out, a.nbr, a.kmax, a.k, a.lanes, rows, slots);
  return repro::last_error();
}

// A CTA takes as many whole rows as its threads have items for (at least
// one) and as the stage's slots hold `lanes` of each; the slots are split
// evenly among its rows, in multiples of `lanes`.
template <int BS, typename T, typename Acc>
int launch_staged(const Args<T>& a) {
  const int per_row = a.lanes * ((a.k + kStagedKC - 1) / kStagedKC);
  const int slots =
      std::min(kStageSlots, std::max(32, a.threads / kThreadsPerSlot));
  const int rows =
      std::max(1, std::min(a.threads / per_row, slots / a.lanes));
  const int per = slots / rows / a.lanes * a.lanes;
  if (a.threads > 512)
    return launch_staged_at<BS, 1024, 1, T, Acc>(a, rows, per);
  if (a.threads > 256)
    return launch_staged_at<BS, 512, 1, T, Acc>(a, rows, per);
  return launch_staged_at<BS, 256, kStagedMinBlocks, T, Acc>(a, rows, per);
}

// k = 1 is the vector step (KC = 1, ld = 1); 6x6 panels take the staged
// body, everything else the sub-warp body.
template <int BS, typename T, typename Acc>
int launch(const Args<T>& a) {
  if (!repro::payload_ok<BS, T>(a.data)) return repro::bad_shape();
  if (a.nbr == 0) return repro::last_error();
  if constexpr (BS == 6) {
    if (a.k > 1) return launch_staged<BS, T, Acc>(a);
  } else {
    if constexpr ((BS + BS) * 8 <= 48) {
      if (a.k > 4) return launch_kc<BS, 8, T, Acc>(a);
    }
    if (a.k > 2) return launch_kc<BS, 4, T, Acc>(a);
    if (a.k > 1) return launch_kc<BS, 2, T, Acc>(a);
  }
  return launch_kc<BS, 1, T, Acc>(a);
}

template <typename T, typename Acc>
int entry(const void* indices, const void* lengths, const void* data,
          const void* dinv, const void* b, const void* x, const void* d,
          const void* coef, void* x_out, void* d_out, int nbr, int kmax,
          int bs, int k, int lanes, int threads, void* stream) {
  const Args<T> a{static_cast<const int*>(indices),
                  static_cast<const int*>(lengths),
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
                  nullptr,
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
    return entry<T, ACC>(indices, nullptr, data, dinv, b, x, d, coef, x_out, \
                         d_out, nbr, kmax, bs, 1, lanes, threads, stream);   \
  }                                                                          \
  REPRO_API int repro_fused_smoother_panel_##SUFFIX(                         \
      const void* indices, const void* lengths, const void* data,            \
      const void* dinv, const void* b, const void* x, const void* d,         \
      const void* coef, void* x_out, void* d_out, int nbr, int kmax, int bs, \
      int k, int lanes, int threads, void* stream) {                         \
    return entry<T, ACC>(indices, lengths, data, dinv, b, x, d, coef, x_out, \
                         d_out, nbr, kmax, bs, k, lanes, threads, stream);   \
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
