// pbjacobi variants timed against the kept kernel (csrc/pbjacobi.cu) by
// `python -m repro_torch.kernels.pbjacobi.variants`; no path of the port
// launches them, and the kernel library does not build this file.
//
// staged: a CTA owns `rows` consecutive block rows (threads / bs, fewer
// when that leaves SMs idle), copies its contiguous dinv and r runs into
// shared memory with 16-byte loads (8-byte pieces where a run starts off
// 16 bytes), loads its x element and omega, and only then, after one
// barrier, runs each element's fma chain over b ascending and the
// __dmul_rn / __dadd_rn of the kept kernel: outputs are bitwise the kept
// kernel's.
#include <cstdint>

#include "common.cuh"

namespace {

__device__ inline void copy_run(double* dst, const double* __restrict__ src,
                                int n) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  if (aligned) {
    const double2* s2 = reinterpret_cast<const double2*>(src);
    double2* d2 = reinterpret_cast<double2*>(dst);
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) d2[i] = s2[i];
    if ((n & 1) && threadIdx.x == 0) dst[n - 1] = src[n - 1];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

template <int BS>
__global__ void pbjacobi_staged(const double* __restrict__ dinv,
                                const double* __restrict__ r,
                                const double* __restrict__ x,
                                const double* __restrict__ omega,
                                double omega_value, double* __restrict__ out,
                                int nbr, int rows) {
  extern __shared__ __align__(16) double sh[];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(
      row0 + rows <= nbr ? rows : nbr - row0);
  const int nd = nrows * BS * BS, nr = nrows * BS;
  double* sd = sh;
  double* sr = sh + ((rows * BS * BS + 1) & ~1);     // 16-byte aligned
  const int t = threadIdx.x;
  const long long e = row0 * BS + t;
  const bool active = t < nr;
  const double xv = active ? x[e] : 0.0;
  const double w = omega ? omega[0] : omega_value;
  copy_run(sd, dinv + row0 * BS * BS, nd);
  copy_run(sr, r + row0 * BS, nr);
  __syncthreads();
  if (!active) return;
  const double* d = sd + t * BS;
  const double* rb = sr + (t / BS) * BS;
  double y = 0.0;
#pragma unroll
  for (int b = 0; b < BS; ++b) y = fma(d[b], rb[b], y);
  out[e] = __dadd_rn(xv, __dmul_rn(w, y));
}

template <int BS>
int launch(const double* dinv, const double* r, const double* x,
           const double* omega, double omega_value, double* out, int nbr,
           int rows, cudaStream_t stream) {
  if (nbr == 0) return repro::last_error();
  const int blocks = (nbr + rows - 1) / rows;
  const size_t shmem =
      (((rows * BS * BS + 1) & ~1) + rows * BS) * sizeof(double);
  pbjacobi_staged<BS><<<blocks, rows * BS, shmem, stream>>>(
      dinv, r, x, omega, omega_value, out, nbr, rows);
  return repro::last_error();
}

}  // namespace

// rows: block rows per CTA (rows * bs threads, at most 1024).
REPRO_API int repro_pbjacobi_staged_f64(const void* dinv, const void* r,
                                        const void* x, const void* omega,
                                        double omega_value, void* out,
                                        int nbr, int bs, int rows,
                                        void* stream) {
  auto di = static_cast<const double*>(dinv);
  auto rv = static_cast<const double*>(r);
  auto xv = static_cast<const double*>(x);
  auto w = static_cast<const double*>(omega);
  auto o = static_cast<double*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows * bs > 1024) return repro::bad_shape();
  if (bs == 3)
    return launch<3>(di, rv, xv, w, omega_value, o, nbr, rows, s);
  if (bs == 6)
    return launch<6>(di, rv, xv, w, omega_value, o, nbr, rows, s);
  return repro::bad_shape();
}
