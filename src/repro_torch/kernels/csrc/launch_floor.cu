// An empty kernel: the card's floor for one launch of a given grid, the
// yardstick chip_smoke.py sets beside the small kernels (pbjacobi's
// cases run a few microseconds, about what any launch costs).  No path
// of the port launches it.  Beside it, the host-side record of the
// library's launches (repro::note_launch), which says at which grid to
// time it.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

long long g_launches = 0;
long long g_blocks = 0;
long long g_threads = 0;

}  // namespace

void repro::note_launch(unsigned blocks, int threads) {
  ++g_launches;
  g_blocks = blocks;
  g_threads = threads;
}

// out[0..2] = launches noted so far in this process, and the blocks and
// threads per block of the latest (the empty kernel is not noted).
REPRO_API int repro_launch_record(long long* out) {
  out[0] = g_launches;
  out[1] = g_blocks;
  out[2] = g_threads;
  return 0;
}

REPRO_API int repro_empty_kernel(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024) return repro::bad_shape();
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return repro::last_error();
}
