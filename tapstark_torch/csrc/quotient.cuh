// The quotient's constraint program on Hopper (sm_90a): what every generated
// segment kernel shares. tapstark_torch/air/codegen.py turns the program
// that air/program.py recorded from an AIR into straight-line CUDA C++, cut
// into segments of at most air/program.py SEGMENT_INSTRUCTIONS instructions,
// each its own translation unit and its own __global__ kernel over the whole
// coset (one thread a row, a grid-stride loop). The segments run one after
// another; the last writes the row's folded constraints divided by the
// zeroifier. A launch covers a window of the coset: `rows` rows from the
// coset's row `row0`, the trace's buffer holding them and the rows that
// follow (a shard of the mesh's sharded prover step reads its own rows
// and the halo after them); the whole coset is the window of m rows from
// row 0, whose next rows wrap. Plain version: the eager
// ProverConstraintFolder (program.py quotient_eager, over the window).
//
// Replaces no Pallas kernel. The JAX package evaluates the same folder
// under one jit (tapstark/stark/prover.py quotient_values), which XLA fuses.
//
// A segment's statements are SSA: each instruction a fresh local uint32_t
// (BabyBear add, sub, mul, neg on Montgomery words, babybear.cuh), each
// constant a literal Montgomery word, each public value a word of the
// arguments. A trace column is loaded once a segment, at its first use,
// from the window laid out by columns (tq[j * ld + r] for the window's row
// r: a warp's read of a column is one 128-byte line; the next row is r +
// next_step, less ld where that reaches ld). The values live across a cut,
// the 4-word accumulator among them, go through `live`, laid out
// [value][r] with the same leading dimension (coalesced too): a segment
// stores each one
// it defines right after the statement, and loads each one it reads at its
// first use. The selectors are computed from the coset's parameters at the
// coset's row row0 + r, in the segment that first reads them (codegen.py),
// and cross cuts as values. The
// folds of a segment are a sum of products by powers of alpha (fold_pair
// below), so they form no chain.
//
// What bounds it: instruction issue. The 1548-column Blake3 sponge AIR runs
// ~51,000 instructions a row (24,000 products, 24,000 adds and subs, 3,500
// folds) against the 6 KiB of trace the row reads. The design keeps every
// value in registers inside a segment; ptxas spills where more than 255 are
// live (its report is printed for each segment); the cuts are placed where
// the fewest values are live, so the boundary traffic stays small.

#pragma once

#include <cstdint>

#include "babybear.cuh"

// Public values a program may read (air/program.py MAX_PUBLIC).
constexpr int kMaxPublic = 64;
constexpr int kQuotientBlock = 128;
constexpr long long kQuotientMaxBlocks = 4096;

// The arguments every segment takes (air/codegen.py QuotientArgs mirrors it).
struct QuotientArgs {
  const uint32_t* tq;     // (width, ld) the window's trace rows and those after them, by columns, Montgomery
  uint32_t* live;         // (slots, ld) values carried across cuts
  uint32_t* out;          // (rows, 4) the window's quotient, Montgomery
  const uint32_t* coset;  // x tables lo (2^log_lo) | hi (2^log_hi), then zh and 1/zh (2^log_q each)
  const uint4* alpha_pows;  // alpha^0, alpha^1, ... (as many as a segment folds, and one), Montgomery
  long long row0;         // the window's first row in the coset
  long long rows;         // the window's rows
  long long ld;           // the buffers' leading dimension: rows + next_step or more, or m for the whole coset
  long long next_step;
  int log_lo, log_hi, log_q;
  uint32_t g_inv;         // the trace domain's generator, inverted, Montgomery
  uint32_t pub[kMaxPublic];
};

namespace {

constexpr uint32_t kMontOne = 0x0ffffffeu;  // 2^32 mod p

// t * 2^-32 mod p, for t < p * 2^32 (the REDC of mont_mul).
__device__ __forceinline__ uint32_t mont_reduce(uint64_t t) {
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t hi = static_cast<uint32_t>(t >> 32);
  const uint32_t q = lo * kMu;
  const uint32_t u = hi + __umulhi(q, kP) + (lo != 0u);
  return u >= kP ? u - kP : u;
}

__device__ __forceinline__ uint32_t neg_mod(uint32_t x) { return x == 0u ? 0u : kP - x; }

__device__ __forceinline__ uint64_t wide(uint32_t a, uint32_t b) { return static_cast<uint64_t>(a) * b; }

// The folds. A segment that folds x_0 .. x_{F-1} (in eval order) leaves
// acc * alpha^F + sum_i x_i * alpha^(F-1-i): the field element that F steps
// of acc = acc * alpha + x leave, without their chain. Each x_i * alpha^e
// (x base, the power from the table, the same word in every thread) is four
// wide products; two folds share a coordinate's reduction (each pair of
// products < 2p^2 < p * 2^32).
__device__ __forceinline__ void fold_pair(uint32_t (&sum)[4], const QuotientArgs& a, int e, uint32_t x, uint32_t y) {
  const uint4 u = __ldg(a.alpha_pows + e), v = __ldg(a.alpha_pows + e - 1);  // x's power, y's
  sum[0] = add_mod(sum[0], mont_reduce(wide(x, u.x) + wide(y, v.x)));
  sum[1] = add_mod(sum[1], mont_reduce(wide(x, u.y) + wide(y, v.y)));
  sum[2] = add_mod(sum[2], mont_reduce(wide(x, u.z) + wide(y, v.z)));
  sum[3] = add_mod(sum[3], mont_reduce(wide(x, u.w) + wide(y, v.w)));
}

__device__ __forceinline__ void fold_one(uint32_t (&sum)[4], const QuotientArgs& a, int e, uint32_t x) {
  const uint4 u = __ldg(a.alpha_pows + e);
  sum[0] = add_mod(sum[0], mont_mul(x, u.x));
  sum[1] = add_mod(sum[1], mont_mul(x, u.y));
  sum[2] = add_mod(sum[2], mont_mul(x, u.z));
  sum[3] = add_mod(sum[3], mont_mul(x, u.w));
}

constexpr uint32_t kMontW = 0x37ffffe9u;  // W = 11 as a Montgomery word, 11 * 2^32 mod p

// acc = acc * alpha^e + sum in the quartic extension (x^4 = W): each
// coordinate is four products, summed in pairs (each pair < 2p^2) and
// each pair reduced once.
__device__ __forceinline__ void fold_segment(uint32_t (&acc)[4], const QuotientArgs& a, int e,
                                             const uint32_t (&sum)[4]) {
  const uint4 u = __ldg(a.alpha_pows + e);
  const uint32_t a0 = acc[0], a1 = acc[1], a2 = acc[2], a3 = acc[3];
  const uint32_t w1 = mont_mul(u.y, kMontW), w2 = mont_mul(u.z, kMontW), w3 = mont_mul(u.w, kMontW);
  acc[0] = add_mod(add_mod(mont_reduce(wide(a0, u.x) + wide(a1, w3)), mont_reduce(wide(a2, w2) + wide(a3, w1))),
                   sum[0]);
  acc[1] = add_mod(add_mod(mont_reduce(wide(a0, u.y) + wide(a1, u.x)), mont_reduce(wide(a2, w3) + wide(a3, w2))),
                   sum[1]);
  acc[2] = add_mod(add_mod(mont_reduce(wide(a0, u.z) + wide(a1, u.y)), mont_reduce(wide(a2, u.x) + wide(a3, w3))),
                   sum[2]);
  acc[3] = add_mod(add_mod(mont_reduce(wide(a0, u.w) + wide(a1, u.z)), mont_reduce(wide(a2, u.y) + wide(a3, u.x))),
                   sum[3]);
}

// x^(p-2) = 1/x (Fermat); p - 2 = 0b1110 followed by 27 ones: x^7, one
// square, then nine rounds of three squares and a product by x^7.
__device__ __forceinline__ uint32_t mont_inv(uint32_t x) {
  const uint32_t x3 = mont_mul(mont_mul(x, x), x);
  const uint32_t x7 = mont_mul(mont_mul(x3, x3), x);
  uint32_t t = mont_mul(x7, x7);
  for (int i = 0; i < 9; ++i) {
    t = mont_mul(t, t);
    t = mont_mul(t, t);
    t = mont_mul(mont_mul(t, t), x7);
  }
  return t;
}

// The coset point of `row`: shift * omega^row = hi[row >> log_lo] * lo[row mod 2^log_lo].
__device__ __forceinline__ uint32_t coset_x(const QuotientArgs& a, long long row) {
  const long long lo_mask = (1ll << a.log_lo) - 1;
  return mont_mul(__ldg(a.coset + (1ll << a.log_lo) + (row >> a.log_lo)), __ldg(a.coset + (row & lo_mask)));
}

// x^n - 1 takes 2^log_q values over the coset: entry row mod 2^log_q of
// the zeroifier table (which = 0), or of its inverses (which = 1).
__device__ __forceinline__ uint32_t coset_zh(const QuotientArgs& a, long long row, int which) {
  const long long base = (1ll << a.log_lo) + (1ll << a.log_hi) + (static_cast<long long>(which) << a.log_q);
  return __ldg(a.coset + base + (row & ((1ll << a.log_q) - 1)));
}

// is_first_row = zh / (x - 1), is_last_row = zh / (x - g^-1): one inverse
// of the product of both denominators.
__device__ __forceinline__ void first_and_last_row(uint32_t x, uint32_t zh, uint32_t g_inv, uint32_t& first,
                                                   uint32_t& last) {
  const uint32_t d1 = sub_mod(x, kMontOne), d2 = sub_mod(x, g_inv);
  const uint32_t inv = mont_inv(mont_mul(d1, d2));
  first = mont_mul(zh, mont_mul(inv, d2));
  last = mont_mul(zh, mont_mul(inv, d1));
}

__device__ __forceinline__ uint32_t first_row(uint32_t x, uint32_t zh) {
  return mont_mul(zh, mont_inv(sub_mod(x, kMontOne)));
}

__device__ __forceinline__ uint32_t last_row(uint32_t x, uint32_t zh, uint32_t g_inv) {
  return mont_mul(zh, mont_inv(sub_mod(x, g_inv)));
}

// The last segment's store: the accumulator times 1/zh at the coset's row
// `row`, into the window's row r.
__device__ __forceinline__ void store_quotient(const QuotientArgs& a, long long r, long long row,
                                               const uint32_t (&acc)[4]) {
  const uint32_t z = coset_zh(a, row, 1);
  uint32_t* o = a.out + 4 * r;
  o[0] = mont_mul(acc[0], z);
  o[1] = mont_mul(acc[1], z);
  o[2] = mont_mul(acc[2], z);
  o[3] = mont_mul(acc[3], z);
}

__host__ __device__ inline unsigned quotient_grid(long long rows) {
  const long long blocks = (rows + kQuotientBlock - 1) / kQuotientBlock;
  return static_cast<unsigned>(blocks < kQuotientMaxBlocks ? blocks : kQuotientMaxBlocks);
}

}  // namespace

// A segment's C entry point: on the card, the launch on the caller's stream
// (returns the launch's CUDA error); on the host (tests/cuda_host_shim),
// the launch's threads one after another.
#ifdef __CUDACC__
#define QUOTIENT_SEGMENT_ENTRY(name, kernel)                                                      \
  extern "C" int name(const QuotientArgs* a, void* stream) {                                      \
    kernel<<<quotient_grid(a->rows), kQuotientBlock, 0, static_cast<cudaStream_t>(stream)>>>(*a); \
    return static_cast<int>(cudaGetLastError());                                                  \
  }
#else
void host_launch_segment(void (*kernel)(QuotientArgs), const QuotientArgs& a);
#define QUOTIENT_SEGMENT_ENTRY(name, kernel) \
  extern "C" void name(const QuotientArgs* a) { host_launch_segment(kernel, *a); }
#endif
