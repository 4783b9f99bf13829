// Column NTTs over BabyBear on Hopper (sm_90a): the member transforms of
// the four-step LDE routes outside the fused range
// (tapstark_torch/poly/cols_ntt.py).
//
// Replaces the TPU kernels of tapstark/poly/pallas_ntt.py:
//   dit_cols  <- _butterfly_kernel     (K3, via _ntt_cols_pallas): DIT down
//                axis 0 of an (R, B) matrix, rows bit-reversed in, natural
//                out; in two forms (dit_cols.cuh says how each works):
//     - the plain column form (tapstark_dit_cols), and
//     - the first member of a forward coset LDE (tapstark_dit_first), with
//       the glue of the blocks route's forward half taken in: the block
//       scale (and 1/n) on load, the outer twiddle on store, both
//       transposes in the addressing;
//     the same two entry points run lde_forward (K2's counterpart,
//     tapstark_torch/poly/cuda_ntt.py) on lde_inverse's (w, n) layout;
//   dif_cols  <- _dif_butterfly_kernel (K4, via _dif_cols_pallas): DIF,
//                natural in, bit-reversed out; no 1/n and no outer twiddle
//                inside (the caller applies them, as the reference does).
//
// What bounds them, and the DIT's design: dit_cols.cuh. The DIF kernel
// is the first design, kept for the inverse half until its own redesign:
// a block takes all R rows of L consecutive lanes (the largest power of
// two <= 32 lanes that keeps the R x L tile within 128 KiB, 16 at R =
// 2^11), runs the log R radix-2 stages in shared memory with one barrier a
// stage, reads its twiddles from device memory per butterfly and writes
// the tile back: shared-memory traffic and the barrier between stages set
// its time. The largest R in one pass is 2^kMaxLogR = 2^14 for both
// directions, which covers the four-step split of every size up to the
// field's 2^27; larger R is refused.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "dit_cols.cuh"

namespace {

constexpr int kMaxLogR = kDitMaxLogR;
constexpr int kTileLogWords = 15;  // 2^15 words = 128 KiB of shared memory
constexpr int kMaxLogLanes = 5;

// One block: all 2^log_r rows of 2^log_l consecutive lanes. tw is the
// (2, log_r, R/2) table of cols_ntt.packed_twiddles_shoup: canonical stage
// twiddles, then their Shoup companions.
__global__ void __launch_bounds__(1024)
    dif_cols_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                    const uint32_t* __restrict__ tw, int log_r, long long b, int log_l) {
  extern __shared__ uint32_t sm[];
  const uint32_t half_r = 1u << (log_r - 1);
  const uint32_t lmask = (1u << log_l) - 1u;
  const uint32_t words = 1u << (log_r + log_l);
  const long long col0 = static_cast<long long>(blockIdx.x) << log_l;

  for (uint32_t i = threadIdx.x; i < words; i += blockDim.x) {
    const long long c = col0 + (i & lmask);
    sm[i] = c < b ? src[static_cast<long long>(i >> log_l) * b + c] : 0u;
  }
  __syncthreads();

  const uint32_t pairs = words >> 1;
  for (int st = 0; st < log_r; ++st) {
    const int s = log_r - st;  // butterflies span 2^s rows
    const uint32_t half = 1u << (s - 1);
    const uint32_t* wc = tw + static_cast<size_t>(s - 1) * half_r;
    const uint32_t* ws = tw + static_cast<size_t>(log_r + s - 1) * half_r;
    for (uint32_t q = threadIdx.x; q < pairs; q += blockDim.x) {
      const uint32_t lane = q & lmask;
      const uint32_t pr = q >> log_l;
      const uint32_t j = pr & (half - 1u);
      const uint32_t r0 = ((pr >> (s - 1)) << s) | j;
      uint32_t* p0 = &sm[(r0 << log_l) | lane];
      uint32_t* p1 = &sm[((r0 + half) << log_l) | lane];
      const uint32_t lo = reduce2p(*p0);
      const uint32_t hi = reduce2p(*p1);
      *p0 = lo + hi;
      *p1 = shoup_mul(wc[j], ws[j], lo - hi + kP);
    }
    __syncthreads();
  }

  for (uint32_t i = threadIdx.x; i < words; i += blockDim.x) {
    const long long c = col0 + (i & lmask);
    if (c < b) dst[static_cast<long long>(i >> log_l) * b + c] = reduce2p(sm[i]);
  }
}

}  // namespace

extern "C" {

// The largest log R one launch takes.
int tapstark_ntt_cols_max_log_r() { return kMaxLogR; }

// src, dst: (2^log_r, b) row-major uint32 (Montgomery words), distinct.
// DIF, natural rows in, bit-reversed out (K4). tw: (2, log_r,
// 2^(log_r-1)) Shoup table of the direction wanted.
int tapstark_dif_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r,
                      long long b, void* stream) {
  if (log_r < 1 || log_r > kMaxLogR || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  int log_l = kTileLogWords - log_r;
  if (log_l > kMaxLogLanes) log_l = kMaxLogLanes;
  int need = 0;
  while ((1ll << need) < b && need < log_l) ++need;
  log_l = need;
  const size_t smem = sizeof(uint32_t) << (log_r + log_l);
  const long long blocks = (b + (1ll << log_l) - 1) >> log_l;
  unsigned threads = 1u << (log_r + log_l - 1);
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      dif_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dif_cols_kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, tw, log_r, b, log_l);
  return static_cast<int>(cudaGetLastError());
}

// src, dst: (2^log_r, b) as above, distinct. DIT, bit-reversed rows in,
// natural out (K3's column form). tw: (2^log_r - 1) pairs of
// cols_ntt.dit_stage_pairs of the direction wanted.
int tapstark_dit_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r,
                      long long b, void* stream) {
  return static_cast<int>(launch_dit_cols(src, dst, reinterpret_cast<const uint2*>(tw), log_r, b,
                                          static_cast<cudaStream_t>(stream)));
}

// The first member of a forward coset LDE (K3's fused form, and K2's first
// launch): x holds n = 2^(log_r + log_c) coefficients in bitrev_n order of
// `width` columns, coefficient j of column c at x[j * x_row + c * x_col];
// out: (2^log_c, 2^log_r * 2^log_blowup * width), B[p2, (k1, rb, c)]. The
// tables are those of dit_tables.first_member_tables; h = log2 of lo's
// length.
int tapstark_dit_first(const uint32_t* x, long long x_row, long long x_col, uint32_t* out,
                       const uint32_t* tw, const uint32_t* s1, const uint32_t* s2,
                       const uint32_t* hi, const uint32_t* lo, int log_r, int log_c, int h,
                       int log_blowup, int width, void* stream) {
  return static_cast<int>(launch_dit_first(
      dit_first_args(x, x_row, x_col, out, tw, s1, s2, hi, lo, log_r, log_c, h, log_blowup, width),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
