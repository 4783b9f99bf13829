// The quotient's generated segments (tapstark_torch/air/codegen.py, shared
// code in tapstark_torch/csrc/quotient.cuh) on the host: each segment's
// entry point runs its launch's threads one after another (the kernels have
// no barrier and no shared memory), and host_run_segments runs the segments
// one after another, as the card's stream does, copying the live buffer
// after each. A launch covers the arguments' window of the coset (all of
// it, or a shard's rows with the halo after them in its buffers).
#include <cstring>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
std::barrier<>* host_block_barrier;

#include "quotient.cuh"

void host_launch_segment(void (*kernel)(QuotientArgs), const QuotientArgs& a) {
  for (unsigned bx = 0; bx < gridDim.x; ++bx) {
    for (unsigned tx = 0; tx < blockDim.x; ++tx) {
      blockIdx = dim3(bx);
      threadIdx = dim3(tx);
      kernel(a);
    }
  }
}

extern "C" {

// Runs segments[0 .. n) over a launch of `grid` blocks of `block` threads
// (grid 0: the card's shape for the window, quotient_grid and kQuotientBlock) and copies
// the live buffer's `live_words` words after segment k to snapshots + k *
// live_words.
void host_run_segments(void (*const* segments)(const QuotientArgs*), int n, const QuotientArgs* a, unsigned grid,
                       unsigned block, uint32_t* snapshots, long long live_words) {
  gridDim = dim3(grid ? grid : quotient_grid(a->rows));
  blockDim = dim3(grid ? block : kQuotientBlock);
  for (int k = 0; k < n; ++k) {
    segments[k](a);
    std::memcpy(snapshots + k * live_words, a->live, sizeof(uint32_t) * live_words);
  }
}

}  // extern "C"
