// tapstark_torch/csrc/transcript.cu on the host: its one-thread kernel
// called as the launch's only thread (the kernel has no barrier and no
// shared memory). The CUDA launch in the source is compiled out here.
#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
std::barrier<>* host_block_barrier;

#include "transcript.cu"

extern "C" {

void host_transcript_step(const uint32_t* cv, const uint32_t* pending, int n_pending, const uint32_t* roots,
                          int reps, long long row_stride, long long col_stride, int kind, uint32_t* out) {
  gridDim = blockDim = dim3(1);
  blockIdx = threadIdx = dim3(0);
  transcript_step_kernel(cv, pending, n_pending, roots, reps, row_stride, col_stride, kind, out);
}

}  // extern "C"
