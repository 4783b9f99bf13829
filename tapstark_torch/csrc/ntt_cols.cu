// Column NTTs over BabyBear on Hopper (sm_90a): the member transforms of
// the four-step LDE routes outside the fused range
// (tapstark_torch/poly/cols_ntt.py).
//
// Replaces the TPU kernels of tapstark/poly/pallas_ntt.py:
//   dit_cols <- _butterfly_kernel     (K3, via _ntt_cols_pallas): DIT down
//               axis 0 of an (R, B) matrix, rows bit-reversed in, natural
//               out;
//   dif_cols <- _dif_butterfly_kernel (K4, via _dif_cols_pallas): DIF,
//               natural in, bit-reversed out.
// All log R stages run in one launch; no 1/n and no outer twiddle inside
// (the callers apply them, as the reference does).
//
// Arithmetic. As on the TPU, twiddles are canonical with Shoup companions
// ws = floor(w * 2^32 / p), and values ride lazily in [0, 2p) between
// stages: w * x mod p = w * x - mulhi(ws, x) * p (mod 2^32), in [0, 2p) for
// any x < 2^32. Here mulhi is one __umulhi, not the TPU's 16-bit limb
// emulation. The output is canonicalised to [0, p), so every stored word
// equals the TPU's whatever order the butterflies run in.
//
// What bounds it. A butterfly is ~15 integer instructions (the Shoup
// product, two lazy reductions, an add and a sub) for 16 bytes moved per
// stage through shared memory; device memory is read once and written once
// (8 bytes per element). At the 2^22-row prove's shapes (R = 2^11, B =
// 2^12 .. 2^15) the integer-issue roof and the byte roof are both a few
// tens of microseconds, so shared-memory traffic and the barrier between
// stages set the time, as in coset_lde.cu.
//
// What the design does about it. The transform runs down axis 0 and the
// B lanes are the contiguous axis, so a block takes all R rows of L
// consecutive lanes (a row's L words are one coalesced run), holds the
// R x L tile in shared memory (up to 128 KiB, set per launch above the
// 48 KiB default), runs the log R stages there with one barrier per stage,
// and writes the tile back. L is the largest power of two <= 32 that keeps
// the tile within 128 KiB (16 lanes at R = 2^11), and no wider than B. A
// ragged last block masks its lanes. The largest R in one pass is
// 2^kMaxLogR = 2^14 (two lanes of 64 KiB each), which covers the four-step
// split of every size up to the field's 2^27; larger R is refused.
// Not yet done, for later work: radix-4 register butterflies, a
// bank-conflict-free layout for the first stage, fusing the outer twiddle
// and the transposes into the loads and stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int kMaxLogR = 14;
constexpr int kTileLogWords = 15;  // 2^15 words = 128 KiB of shared memory
constexpr int kMaxLogLanes = 5;

__device__ __forceinline__ uint32_t reduce2p(uint32_t x) { return x >= kP ? x - kP : x; }

// w * x mod p in [0, 2p): wc canonical, ws its Shoup companion, x < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t wc, uint32_t ws, uint32_t x) {
  return wc * x - __umulhi(ws, x) * kP;
}

// One block: all 2^log_r rows of 2^log_l consecutive lanes. tw is the
// (2, log_r, R/2) table of cols_ntt.packed_twiddles_shoup: canonical stage
// twiddles, then their Shoup companions.
template <bool kDif>
__global__ void __launch_bounds__(1024)
    cols_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
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
    const int s = kDif ? log_r - st : st + 1;  // butterflies span 2^s rows
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
      if (kDif) {
        const uint32_t hi = reduce2p(*p1);
        *p0 = lo + hi;
        *p1 = shoup_mul(wc[j], ws[j], lo - hi + kP);
      } else {
        const uint32_t t = reduce2p(shoup_mul(wc[j], ws[j], *p1));
        *p0 = lo + t;
        *p1 = lo - t + kP;
      }
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
// dif = 0: DIT, bit-reversed rows in, natural out (K3); dif = 1: DIF,
// natural in, bit-reversed out (K4). tw: (2, log_r, 2^(log_r-1)) Shoup
// table of the direction wanted.
int tapstark_ntt_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r,
                      long long b, int dif, void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dif) {
    e = cudaFuncSetAttribute(cols_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cols_kernel<true><<<static_cast<unsigned>(blocks), threads, smem, s>>>(src, dst, tw, log_r, b,
                                                                          log_l);
  } else {
    e = cudaFuncSetAttribute(cols_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    cols_kernel<false><<<static_cast<unsigned>(blocks), threads, smem, s>>>(src, dst, tw, log_r, b,
                                                                           log_l);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
