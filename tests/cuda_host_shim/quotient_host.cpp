// The constraint-program kernel of tapstark_torch/csrc/quotient.cuh on the
// host: the launch's threads run one after another (the kernel has no
// barrier and no shared memory), with the launch shape of
// launch_quotient_program.
#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim;
std::barrier<>* host_block_barrier;

#include "quotient.cuh"

extern "C" {

int host_quotient_program(const int* code, int n_code, const uint32_t* consts, const uint32_t* pub,
                          const uint32_t* tq, long long m, int width, long long next_step, const uint32_t* sel,
                          const uint32_t* invz, uint32_t alpha0, uint32_t alpha1, uint32_t alpha2,
                          uint32_t alpha3, uint32_t* scratch, long long threads, uint32_t* out) {
  QuotientArgs a{reinterpret_cast<const int4*>(code), n_code, consts, pub, tq, m, width, next_step, sel, invz,
                 {alpha0, alpha1, alpha2, alpha3}, scratch, threads, out};
  if (a.threads <= 0 || a.threads > a.m || a.n_code < 0) return 1;
  const long long block = a.threads < 256 ? a.threads : 256;
  const long long grid = (a.threads + block - 1) / block;
  blockDim = dim3(static_cast<unsigned>(block));
  for (long long bx = 0; bx < grid; ++bx) {
    for (long long tx = 0; tx < block; ++tx) {
      blockIdx = dim3(static_cast<unsigned>(bx));
      threadIdx = dim3(static_cast<unsigned>(tx));
      quotient_program_kernel(a);
    }
  }
  return 0;
}

}  // extern "C"
