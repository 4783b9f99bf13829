// The quotient's constraint program on Hopper (sm_90a): one thread per row
// of the quotient coset walks the program that tapstark_torch/air/program.py
// recorded from the AIR, and writes the row's folded constraints divided by
// the zeroifier. Entry point in quotient.cu; plain version: the eager
// ProverConstraintFolder (program.py quotient_eager).
//
// Replaces no Pallas kernel. The JAX package evaluates the same folder
// under one jit (tapstark/stark/prover.py quotient_values), which XLA fuses;
// the port evaluated it eagerly, one launch per field operation (about 1.3
// million for the 1548-column Blake3 AIRs), and this kernel takes its place.
//
// The program: n instructions of four int32 words (opcode, dst slot, a, b).
// An operand is a kind in its bits 24 and up and an index below them: a
// slot of this thread's scratch, local column j (tq[row * width + j]), next
// column j (the row next_step further on, modulo m, as torch.roll(tq,
// -next_step) gives it), a public value, a constant of the table (both in
// Montgomery form), or a selector (is_first_row, is_last_row,
// is_transition). add, sub, mul and neg are BabyBear ops on Montgomery
// words (babybear.cuh); fold is acc = acc * alpha + x in the quartic
// extension (x^4 = 11) with x a base value. At the end the row's acc is
// multiplied by inv_zeroifier[row] and stored (m, 4).
//
// What bounds it: instruction issue. The 1548-column Blake3 sponge AIR runs
// ~51,000 instructions a row (24,000 products, 24,000 adds and subs, 3,500
// folds), some 450,000 32-bit operations, against the 6 KiB of trace the row
// reads. What this first design does: every thread of a warp runs the same
// instruction, so the program's words are one broadcast load (__ldg) a warp;
// the slots live in a global scratch laid out [slot][thread], so a warp's
// slot reads and writes are 128-byte lines; the scratch is bounded by the
// threads of one launch (program.py chunk_threads), each walking rows t, t +
// threads, ... . Not yet done: straight-line code generated per AIR with the
// slots in registers, and the row staged in shared memory (a warp's trace
// reads are 32 rows apart).

#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace {

constexpr int kOpAdd = 0, kOpSub = 1, kOpMul = 2, kOpNeg = 3, kOpFold = 4;
constexpr uint32_t kKindSlot = 0, kKindLocal = 1, kKindNext = 2, kKindPublic = 3, kKindConst = 4;
constexpr int kKindShift = 24;
constexpr uint32_t kIndexMask = (1u << kKindShift) - 1;
constexpr uint64_t kExtW = 11;  // x^4 = W

struct QuotientArgs {
  const int4* code;          // (n_code, 4): opcode, dst, a, b
  int n_code;
  const uint32_t* consts;    // Montgomery constants
  const uint32_t* pub;       // Montgomery public values
  const uint32_t* tq;        // (m, width) trace on the coset, Montgomery
  long long m;               // a power of two
  int width;
  long long next_step;
  const uint32_t* sel;       // (3, m): is_first_row, is_last_row, is_transition
  const uint32_t* invz;      // (m,) 1 / zeroifier
  uint32_t alpha[4];         // Montgomery
  uint32_t* scratch;         // (slots, threads)
  long long threads;         // threads of the launch
  uint32_t* out;             // (m, 4)
};

__device__ __forceinline__ uint32_t program_operand(const QuotientArgs& a, uint32_t op, long long row,
                                                    long long next_row, long long t) {
  const uint32_t idx = op & kIndexMask;
  switch (op >> kKindShift) {
    case kKindSlot:
      return a.scratch[static_cast<long long>(idx) * a.threads + t];
    case kKindLocal:
      return a.tq[row * a.width + idx];
    case kKindNext:
      return a.tq[next_row * a.width + idx];
    case kKindPublic:
      return __ldg(a.pub + idx);
    case kKindConst:
      return __ldg(a.consts + idx);
    default:  // a selector
      return a.sel[static_cast<long long>(idx) * a.m + row];
  }
}

// sum of four canonical low products + W * sum of the high ones, mod p
__device__ __forceinline__ uint32_t ext_coord(uint64_t low, uint64_t high) {
  return static_cast<uint32_t>((low + kExtW * high) % kP);
}

__global__ void __launch_bounds__(256) quotient_program_kernel(const __grid_constant__ QuotientArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= a.threads) return;
  for (long long row = t; row < a.m; row += a.threads) {
    const long long next_row = (row + a.next_step) & (a.m - 1);
    uint32_t acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
    for (int k = 0; k < a.n_code; ++k) {
      const int4 ins = __ldg(a.code + k);
      const uint32_t x = program_operand(a, static_cast<uint32_t>(ins.z), row, next_row, t);
      if (ins.x == kOpFold) {
        // acc * alpha, each partial product reduced, then + x
        const uint64_t p00 = mont_mul(acc0, a.alpha[0]), p01 = mont_mul(acc0, a.alpha[1]);
        const uint64_t p02 = mont_mul(acc0, a.alpha[2]), p03 = mont_mul(acc0, a.alpha[3]);
        const uint64_t p10 = mont_mul(acc1, a.alpha[0]), p11 = mont_mul(acc1, a.alpha[1]);
        const uint64_t p12 = mont_mul(acc1, a.alpha[2]), p13 = mont_mul(acc1, a.alpha[3]);
        const uint64_t p20 = mont_mul(acc2, a.alpha[0]), p21 = mont_mul(acc2, a.alpha[1]);
        const uint64_t p22 = mont_mul(acc2, a.alpha[2]), p23 = mont_mul(acc2, a.alpha[3]);
        const uint64_t p30 = mont_mul(acc3, a.alpha[0]), p31 = mont_mul(acc3, a.alpha[1]);
        const uint64_t p32 = mont_mul(acc3, a.alpha[2]), p33 = mont_mul(acc3, a.alpha[3]);
        acc0 = add_mod(ext_coord(p00, p13 + p22 + p31), x);
        acc1 = ext_coord(p01 + p10, p23 + p32);
        acc2 = ext_coord(p02 + p11 + p20, p33);
        acc3 = ext_coord(p03 + p12 + p21 + p30, 0);
        continue;
      }
      uint32_t r;
      if (ins.x == kOpNeg) {
        r = x == 0u ? 0u : kP - x;
      } else {
        const uint32_t y = program_operand(a, static_cast<uint32_t>(ins.w), row, next_row, t);
        r = ins.x == kOpAdd ? add_mod(x, y) : ins.x == kOpSub ? sub_mod(x, y) : mont_mul(x, y);
      }
      a.scratch[static_cast<long long>(ins.y) * a.threads + t] = r;
    }
    const uint32_t z = a.invz[row];
    uint32_t* o = a.out + 4 * row;
    o[0] = mont_mul(acc0, z);
    o[1] = mont_mul(acc1, z);
    o[2] = mont_mul(acc2, z);
    o[3] = mont_mul(acc3, z);
  }
}

#ifdef __CUDACC__
inline cudaError_t launch_quotient_program(const QuotientArgs& a, cudaStream_t stream) {
  if (a.threads <= 0 || a.threads > a.m || a.n_code < 0) return cudaErrorInvalidValue;
  const long long block = a.threads < 256 ? a.threads : 256;
  const long long grid = (a.threads + block - 1) / block;
  quotient_program_kernel<<<static_cast<unsigned>(grid), static_cast<unsigned>(block), 0, stream>>>(a);
  return cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace
