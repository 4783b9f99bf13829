// Coset low-degree extension over BabyBear on Hopper (sm_90a): the inverse
// half of `coset_lde_batch_auto`'s fused route
// (tapstark_torch/poly/cuda_ntt.py).
//
// Replaces the TPU kernel of tapstark/poly/pallas_ntt.py:
//   lde_inverse  <- _fused_intt_kernel (K1): evaluations -> coefficients,
//                   bit-reversed, times 1/n.
// It computes what K1 computes; the data movement is this card's. The
// forward half, lde_forward (K2's counterpart: per blowup block rb, scale
// coefficient j by (shift * w_N^rb)^j, size-n forward NTT, row k * blow +
// rb of the natural-order coset evaluations), has no kernel here: it is
// the four-step DIT pair of dit_cols.cuh, launched through ntt_cols.cu's
// two entry points on the coefficients as lde_inverse leaves them, (w,
// n). Its first member keeps R = 2^11 rows (64 KiB tiles of 8 lanes) and
// puts the rest, at most 2^14 rows, in C, so at the slice's 2^20 rows C =
// 2^9 and the second member's blocks hold 32 lanes: its loads and stores
// are 128-byte runs, and its output rows are already the contiguous (k,
// rb, c) runs of the (n * blow, w) result. The golden sizes (n <= 2^11)
// are one launch of the first member alone.
//
// Field words and products are those of babybear.cuh; every stored word is
// in [0, p).
//
// lde_inverse is the first design, kept until its own redesign. A
// size-2^L transform runs as ceil(L/10) passes of up to 10 radix-2 stages
// (index bits [lo, lo+d)) for independent sub-transforms held in shared
// memory: a block loads 2^d elements of each of G = 2^log_g neighbouring
// sub-transforms (G consecutive low indices, so global loads come in
// G-word runs), does the d stages with a barrier between stages, and
// writes back; 1/n is applied as the last pass stores. It runs decimation
// in frequency (natural in, bit-reversed out), so the forward half
// (bit-reversed in, natural out) needs no permutation pass. What bounds
// it: a butterfly is one Montgomery product plus an add and a sub (~15
// integer instructions) on 16 bytes moved per pass; both roofs are under a
// tenth of a millisecond at 2^20 x 2, so shared-memory traffic, the
// barrier a stage and the twiddle loaded from device memory per butterfly
// set its time.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int kMaxPassBits = 10;  // stages per pass
constexpr int kMaxSmemLog = 13;   // 2^13 words = 32 KiB of shared memory

struct PassArgs {
  const uint32_t* src;
  uint32_t* dst;
  // element strides of the row index j and the column c
  long long src_row, src_col;
  long long dst_row, dst_col;
  const uint32_t* twiddles;  // w_n^{-e}, e < n/2
  uint32_t post_mul;         // multiplier applied at store when has_post
  int has_post;
  int log_n;  // transform size 2^log_n
  int lo;     // lowest index bit this pass transforms
  int d;      // number of stages (index bits lo .. lo+d-1)
  int log_g;  // sub-transforms per block, G = 2^log_g consecutive low indices
};

// One pass: d radix-2 DIF stages on 2^log_g sub-transforms held in shared
// memory. Grid: x = sub-transform groups per column, y = column.
__global__ void __launch_bounds__(256) lde_pass_kernel(const PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int lo = a.lo, d = a.d, log_g = a.log_g;
  const uint32_t gmask = (1u << log_g) - 1u;
  const uint32_t size = 1u << (d + log_g);
  const uint32_t bx = blockIdx.x;
  const uint32_t top = (bx >> (lo - log_g)) << (lo + d);
  const uint32_t bottom = (bx & ((1u << (lo - log_g)) - 1u)) << log_g;
  const uint32_t* src = a.src + blockIdx.y * a.src_col;
  uint32_t* dst = a.dst + blockIdx.y * a.dst_col;

  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) {
    const uint32_t j = top | ((i >> log_g) << lo) | (bottom + (i & gmask));
    sm[i] = src[j * a.src_row];
  }
  __syncthreads();

  const uint32_t butterflies = size >> 1;
  for (int s = 0; s < d; ++s) {
    const int lb = d - 1 - s;  // local bit of this stage
    const int tw_shift = a.log_n - 1 - (lo + lb);
    const uint32_t lmask = (1u << lb) - 1u;
    for (uint32_t q = threadIdx.x; q < butterflies; q += blockDim.x) {
      const uint32_t g = q & gmask;
      const uint32_t r = q >> log_g;
      const uint32_t t0 = ((r >> lb) << (lb + 1)) | (r & lmask);
      // j mod 2^(lo+lb) of the pair's first index, times n / 2^(lo+lb+1)
      const uint32_t e = (((t0 & lmask) << lo) | (bottom + g)) << tw_shift;
      const uint32_t w = a.twiddles[e];
      uint32_t* p0 = &sm[(t0 << log_g) | g];
      uint32_t* p1 = &sm[((t0 | (1u << lb)) << log_g) | g];
      const uint32_t u = *p0, v = *p1;
      *p0 = add_mod(u, v);
      *p1 = mont_mul(sub_mod(u, v), w);
    }
    __syncthreads();
  }

  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) {
    const uint32_t j = top | ((i >> log_g) << lo) | (bottom + (i & gmask));
    uint32_t v = sm[i];
    if (a.has_post) v = mont_mul(v, a.post_mul);
    dst[j * a.dst_row] = v;
  }
}

int num_passes(int log_n) { return (log_n + kMaxPassBits - 1) / kMaxPassBits; }

// Bits of pass k (0-based) when log_n bits are split as evenly as possible.
int pass_bits(int log_n, int k) {
  const int np = num_passes(log_n);
  return log_n / np + (k < log_n % np ? 1 : 0);
}

cudaError_t launch_pass(PassArgs a, int width, cudaStream_t stream) {
  int log_g = kMaxSmemLog - a.d;
  if (log_g > a.lo) log_g = a.lo;
  a.log_g = log_g;
  const uint32_t size = 1u << (a.d + log_g);
  unsigned threads = size >> 1;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  const dim3 grid(1u << (a.log_n - a.d - log_g), width);
  const size_t smem = size * sizeof(uint32_t);
  lde_pass_kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p and MU as compiled, so the loader can check them against the field's.
void tapstark_lde_constants(uint32_t* out) {
  out[0] = kP;
  out[1] = kMu;
}

// evals (n, width) natural order -> coeffs (width, n), position p holding
// coefficient bitrev(p) times 1/n. tw_inv: (n/2,) powers of w_n^{-1}.
int tapstark_lde_inverse(const uint32_t* evals, uint32_t* coeffs, const uint32_t* tw_inv,
                         int log_n, int width, uint32_t n_inv_mont, void* stream) {
  const long long n = 1ll << log_n;
  const int np = num_passes(log_n);
  int hi = log_n;
  for (int k = 0; k < np; ++k) {
    PassArgs a{};
    a.d = pass_bits(log_n, k);
    a.lo = hi - a.d;
    hi = a.lo;
    a.log_n = log_n;
    a.twiddles = tw_inv;
    if (k == 0) {
      a.src = evals;
      a.src_row = width;
      a.src_col = 1;
    } else {
      a.src = coeffs;
      a.src_row = 1;
      a.src_col = n;
    }
    a.dst = coeffs;
    a.dst_row = 1;
    a.dst_col = n;
    a.has_post = k == np - 1;
    a.post_mul = n_inv_mont;
    const cudaError_t e = launch_pass(a, width, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
