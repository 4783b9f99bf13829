// The entry point of the quotient's constraint program on Hopper (sm_90a):
// tapstark_torch/air/program.py quotient_program launches it for every
// prove on the card. What it computes, what bounds it and the design:
// quotient.cuh. It replaces no Pallas kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "quotient.cuh"

extern "C" {

// code: (n_code, 4) int32 program; consts, pub: Montgomery words; tq: (m,
// width) Montgomery trace on the coset; sel: (3, m) selectors; invz: (m,);
// alpha: Montgomery; scratch: (slots, threads) words; out: (m, 4).
int tapstark_quotient_program(const int* code, int n_code, const uint32_t* consts, const uint32_t* pub,
                              const uint32_t* tq, long long m, int width, long long next_step,
                              const uint32_t* sel, const uint32_t* invz, uint32_t alpha0, uint32_t alpha1,
                              uint32_t alpha2, uint32_t alpha3, uint32_t* scratch, long long threads,
                              uint32_t* out, void* stream) {
  QuotientArgs a{reinterpret_cast<const int4*>(code), n_code, consts, pub, tq, m, width, next_step, sel, invz,
                 {alpha0, alpha1, alpha2, alpha3}, scratch, threads, out};
  return static_cast<int>(launch_quotient_program(a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
