// Coset low-degree extension over BabyBear on Hopper (sm_90a): the two
// halves of `coset_lde_batch_auto` (tapstark_torch/poly/cuda_ntt.py).
//
// Replaces the TPU kernels of tapstark/poly/pallas_ntt.py:
//   lde_inverse  <- _fused_intt_kernel (K1): evaluations -> coefficients,
//                   bit-reversed, times 1/n;
//   lde_forward  <- _fused_fwd_kernel  (K2): per blowup block rb, scale
//                   coefficient j by (shift * w_N^rb)^j, size-n forward
//                   NTT, write row k * blow + rb of the natural-order
//                   coset evaluations.
// They compute what K1 and K2 compute; the data movement is this card's.
//
// Field words and products are those of babybear.cuh; every stored word is
// in [0, p).
//
// What bounds it. A butterfly is one Montgomery product (mul.wide, mul.lo,
// mul.hi, a few adds and selects) plus an add and a sub: ~15 integer
// instructions, several of them on the half-rate multiply pipe, for 16
// bytes of data moved per pass. At the slice's 2^20 x 2 columns x blowup 4
// the whole LDE is ~1e8 butterflies (~1.5e9 integer ops) against ~0.2 GB
// of device-memory traffic (3.35 TB/s): both under a tenth of a
// millisecond on an H100, so neither roof is near and shared-memory
// traffic, barriers and launches set the time.
//
// What the design does about it. A size-2^L transform runs as ceil(L/10)
// passes. Each pass takes up to 10 consecutive radix-2 stages (bit
// positions [lo, lo+d) of the index) and runs them for independent
// sub-transforms entirely in shared memory: a block loads 2^d elements of
// each of G = 2^log_g neighbouring sub-transforms (G consecutive low
// indices, so global loads come in G-word runs), does the d stages with a
// barrier between stages, and writes back. So the slice's 2^20 transform is
// two passes, i.e. two reads and two writes of the column instead of 20,
// and the small golden sizes are one pass in one block. Twiddles come from
// one table w_n^e (e < n/2) per size and direction; the block scales
// (one table per blowup block, in bit-reversed order) are applied as the
// first pass loads; 1/n as the inverse's last pass stores. The inverse
// runs decimation in frequency (natural in, bit-reversed out) and the
// forward decimation in time (bit-reversed in, natural out), so no
// permutation pass is needed between or after them.
// Not yet done, for later work: radix-4/8 register butterflies, Shoup
// twiddles, bank-conflict-free shared layouts, one fused launch per half.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int kMaxPassBits = 10;  // stages per pass
constexpr int kMaxSmemLog = 13;   // 2^13 words = 32 KiB of shared memory

struct PassArgs {
  const uint32_t* src;
  uint32_t* dst;
  // element strides of the row index j, the column c and the batch rb
  long long src_row, src_col, src_batch;
  long long dst_row, dst_col, dst_batch;
  const uint32_t* twiddles;  // w_n^e, e < n/2 (w inverted for the inverse)
  const uint32_t* scales;    // (batch, n) multipliers applied at load, or null
  uint32_t post_mul;         // multiplier applied at store when has_post
  int has_post;
  int log_n;  // transform size 2^log_n
  int lo;     // lowest index bit this pass transforms
  int d;      // number of stages (index bits lo .. lo+d-1)
  int log_g;  // sub-transforms per block, G = 2^log_g consecutive low indices
};

// One pass: d radix-2 stages on 2^log_g sub-transforms held in shared
// memory. Grid: x = sub-transform groups per column, y = column, z = batch.
template <bool kDif>
__global__ void __launch_bounds__(256) lde_pass_kernel(const PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int lo = a.lo, d = a.d, log_g = a.log_g;
  const uint32_t gmask = (1u << log_g) - 1u;
  const uint32_t size = 1u << (d + log_g);
  const uint32_t bx = blockIdx.x;
  const uint32_t top = (bx >> (lo - log_g)) << (lo + d);
  const uint32_t bottom = (bx & ((1u << (lo - log_g)) - 1u)) << log_g;
  const uint32_t* src = a.src + blockIdx.y * a.src_col + blockIdx.z * a.src_batch;
  uint32_t* dst = a.dst + blockIdx.y * a.dst_col + blockIdx.z * a.dst_batch;
  const uint32_t* scales =
      a.scales ? a.scales + (static_cast<long long>(blockIdx.z) << a.log_n) : nullptr;

  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) {
    const uint32_t j = top | ((i >> log_g) << lo) | (bottom + (i & gmask));
    uint32_t v = src[j * a.src_row];
    if (scales) v = mont_mul(v, scales[j]);
    sm[i] = v;
  }
  __syncthreads();

  const uint32_t butterflies = size >> 1;
  for (int s = 0; s < d; ++s) {
    const int lb = kDif ? d - 1 - s : s;  // local bit of this stage
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
      if (kDif) {
        *p0 = add_mod(u, v);
        *p1 = mont_mul(sub_mod(u, v), w);
      } else {
        const uint32_t t = mont_mul(v, w);
        *p0 = add_mod(u, t);
        *p1 = sub_mod(u, t);
      }
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

cudaError_t launch_pass(bool dif, PassArgs a, int width, int batch, cudaStream_t stream) {
  int log_g = kMaxSmemLog - a.d;
  if (log_g > a.lo) log_g = a.lo;
  a.log_g = log_g;
  const uint32_t size = 1u << (a.d + log_g);
  unsigned threads = size >> 1;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  const dim3 grid(1u << (a.log_n - a.d - log_g), width, batch);
  const size_t smem = size * sizeof(uint32_t);
  if (dif) {
    lde_pass_kernel<true><<<grid, threads, smem, stream>>>(a);
  } else {
    lde_pass_kernel<false><<<grid, threads, smem, stream>>>(a);
  }
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
    const cudaError_t e =
        launch_pass(true, a, width, 1, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// coeffs (width, n) as lde_inverse leaves them -> out (n << log_blowup,
// width) natural order. scales: (blow, n), block rb's powers of
// shift * w_N^rb in bit-reversed order. scratch: (blow, width, n), used
// when the transform takes more than one pass. tw: (n/2,) powers of w_n.
int tapstark_lde_forward(const uint32_t* coeffs, uint32_t* scratch, uint32_t* out,
                         const uint32_t* tw, const uint32_t* scales, int log_n,
                         int log_blowup, int width, void* stream) {
  const long long n = 1ll << log_n;
  const int blow = 1 << log_blowup;
  const int np = num_passes(log_n);
  int lo = 0;
  for (int k = 0; k < np; ++k) {
    PassArgs a{};
    a.d = pass_bits(log_n, k);
    a.lo = lo;
    lo += a.d;
    a.log_n = log_n;
    a.twiddles = tw;
    if (k == 0) {
      a.src = coeffs;
      a.src_row = 1;
      a.src_col = n;
      a.src_batch = 0;
      a.scales = scales;
    } else {
      a.src = scratch;
      a.src_row = 1;
      a.src_col = n;
      a.src_batch = n * width;
    }
    if (k == np - 1) {
      a.dst = out;
      a.dst_row = static_cast<long long>(blow) * width;
      a.dst_col = 1;
      a.dst_batch = width;
    } else {
      a.dst = scratch;
      a.dst_row = 1;
      a.dst_col = n;
      a.dst_batch = n * width;
    }
    const cudaError_t e =
        launch_pass(false, a, width, blow, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // extern "C"
