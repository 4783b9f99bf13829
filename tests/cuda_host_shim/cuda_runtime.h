// Stand-ins for the CUDA built-ins that tapstark_torch/csrc/dit_cols.cuh,
// dif_cols.cuh, matmul_ntt.cuh, quotient.cuh (with the quotient's
// generated segments) and transcript.cu use, so that their kernels and
// helpers compile with g++ and run on the host for the tests: one
// std::thread per CUDA thread, one block at a time, a std::barrier for
// __syncthreads (see dit_host.cpp); matmul_host.cpp runs the limb-matmul
// kernel's data flow, quotient_host.cpp the quotient's segments, one after
// another, transcript_host.cpp the transcript step's one thread.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 {
  uint32_t x, y;
};
struct uint4 {
  uint32_t x, y, z, w;
};

extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
extern std::barrier<>* host_block_barrier;

inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
// Byte n of the result is byte (s >> 4n) & 7 of the 8 bytes y:x.
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i, x >>= 1) r = (r << 1) | (x & 1u);
  return r;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __grid_constant__
