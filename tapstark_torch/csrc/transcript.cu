// One step of the FRI commit phase's transcript on Hopper (sm_90a): the
// layer's observe_commitment(roots) then sample() of the extension beta,
// word for word the host BfChallenger's (tapstark_torch/challenger), from
// the (R, 8) root words the SHA-256 kernels left on the card. Wrapped by
// tapstark_torch/challenger/device_tail.py transcript_step, which
// DeviceTailChain launches once a layer; its plain version is the eager
// step beside it (hashes/blake3.py compress_batch on int64 tensors).
//
// Replaces no Pallas kernel: the JAX package jits this step as jnp
// (tapstark/challenger/device_tail.py:106 _step). Without it the prover
// copies each layer's roots to the host and sends beta back before it can
// fold; as eager torch the step is ~15,000 launches.
//
// What bounds it: latency. The work is a serial chain of compressions,
// ceil(R / 2) for the digest (one blake3 chunk of R * 32 bytes) and one or
// two for the duplex, about 1 KB read and 64 B written. The design is one
// thread with every word in registers: the message schedule is written out
// (no table), each compression fully unrolled, so its four independent G
// functions of each half-round give the scheduler its only parallelism.
// The roots are read strided, as K6's wrapper leaves them (a transposed
// view of its level buffer), and byte-swapped: the commitment's bytes are
// the big-endian SHA words, the digest parses them little-endian.
//
// The same source builds with g++ against tests/cuda_host_shim
// (transcript_host.cpp): the launch below is CUDA-only.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr uint32_t kR2 = 0x45dddde3u;  // 2^64 mod p: to_mont(x) = mont_mul(x, kR2)
constexpr uint32_t kChunkStart = 1u, kChunkEnd = 2u, kRoot = 8u;
constexpr uint32_t kDuplexFlags = kChunkStart | kChunkEnd | kRoot;  // challenger FLAGS
constexpr int kMaxPending = 15;  // input words a challenger can hold (its rate is 16)
constexpr int kMaxReps = 32;     // R * 32 bytes in one blake3 chunk
constexpr int kBlake3 = 0, kTestPermutation = 1;

__host__ __device__ __forceinline__ void blake3_iv(uint32_t* v) {
  v[0] = 0x6A09E667u;
  v[1] = 0xBB67AE85u;
  v[2] = 0x3C6EF372u;
  v[3] = 0xA54FF53Au;
  v[4] = 0x510E527Fu;
  v[5] = 0x9B05688Cu;
  v[6] = 0x1F83D9ABu;
  v[7] = 0x5BE0CD19u;
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x & 0xFF00u) << 8) | (x << 24);
}

__device__ __forceinline__ void g(uint32_t* v, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  v[a] = v[a] + v[b] + mx;
  v[d] = rotr(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + my;
  v[d] = rotr(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr(v[b] ^ v[c], 7);
}

// blake3's message permutation (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8), in place.
__device__ __forceinline__ void permute(uint32_t* m) {
  const uint32_t t0 = m[0], t1 = m[1], t2 = m[2], t3 = m[3], t4 = m[4], t5 = m[5], t6 = m[6], t7 = m[7];
  const uint32_t t8 = m[8], t9 = m[9], t10 = m[10], t11 = m[11], t12 = m[12], t13 = m[13], t14 = m[14],
                 t15 = m[15];
  m[0] = t2, m[1] = t6, m[2] = t3, m[3] = t10, m[4] = t7, m[5] = t0, m[6] = t4, m[7] = t13;
  m[8] = t1, m[9] = t11, m[10] = t12, m[11] = t5, m[12] = t9, m[13] = t14, m[14] = t15, m[15] = t8;
}

// One blake3 compression at counter 0: cv <- the first 8 output words, h_i = v_i ^ v_(i+8).
__device__ __forceinline__ void compress(uint32_t* cv, const uint32_t* block, uint32_t block_len, uint32_t flags) {
  uint32_t v[16], m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = block[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = cv[i];
  blake3_iv(v + 8);
  v[12] = 0u;
  v[13] = 0u;
  v[14] = block_len;
  v[15] = flags;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(v, 0, 4, 8, 12, m[0], m[1]);
    g(v, 1, 5, 9, 13, m[2], m[3]);
    g(v, 2, 6, 10, 14, m[4], m[5]);
    g(v, 3, 7, 11, 15, m[6], m[7]);
    g(v, 0, 5, 10, 15, m[8], m[9]);
    g(v, 1, 6, 11, 12, m[10], m[11]);
    g(v, 2, 7, 8, 13, m[12], m[13]);
    g(v, 3, 4, 9, 14, m[14], m[15]);
    if (r != 6) permute(m);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

// The challenger's duplex step on a zero-padded 16-word block of `len` words.
__device__ __forceinline__ void duplex(uint32_t* cv, const uint32_t* block, int len, int kind) {
  if (kind == kBlake3) {
    compress(cv, block, 4u * len, kDuplexFlags);
    return;
  }
  // TestPermutation: mixed[i] = (cv[i] ^ b[i]) + b[i + 8] + 4 len + i, output reversed
  uint32_t mixed[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mixed[i] = (cv[i] ^ block[i]) + block[i + 8] + 4u * len + i;
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = mixed[7 - i];
}

// cv_in (8 words), pending (n_pending words), roots[r * row_stride + w * col_stride] for r < reps,
// w < 8; out: cv' (8), beta in Montgomery form (4), the popped words (4).
__global__ void __launch_bounds__(32)
    transcript_step_kernel(const uint32_t* __restrict__ cv_in, const uint32_t* __restrict__ pending, int n_pending,
                           const uint32_t* __restrict__ roots, int reps, long long row_stride, long long col_stride,
                           int kind, uint32_t* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  // observe_commitment: blake3 of the R roots' bytes, one chunk, counter 0
  const int words = 8 * reps, blocks = (words + 15) / 16;
  uint32_t digest[8];
  blake3_iv(digest);
  for (int b = 0; b < blocks; ++b) {
    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 16 * b + i;
      m[i] = k < words ? bswap(roots[(k >> 3) * row_stride + (k & 7) * col_stride]) : 0u;
    }
    const uint32_t flags = (b == 0 ? kChunkStart : 0u) | (b == blocks - 1 ? kChunkEnd | kRoot : 0u);
    const int len = 4 * words - 64 * b;
    compress(digest, m, len < 64 ? len : 64, flags);
  }
  // the duplex absorbs pending || digest: a compression at 16 words, then
  // sample() squeezes the rest (or, with nothing left, pops the last output)
  uint32_t buf[kMaxPending + 8];
  for (int i = 0; i < n_pending; ++i) buf[i] = pending[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) buf[n_pending + i] = digest[i];
  uint32_t cv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = cv_in[i];
  int left = n_pending + 8, at = 0;
  if (left >= 16) {
    duplex(cv, buf, 16, kind);
    at = 16;
    left -= 16;
  }
  if (left > 0 || at == 0) {
    uint32_t block[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) block[i] = i < left ? buf[at + i] : 0u;
    duplex(cv, block, left, kind);
  }
  // sample() pops from the end of the output: cv[7], cv[6], cv[5], cv[4]
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = cv[i];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t w = cv[7 - j];
    out[8 + j] = mont_mul(w % kP, kR2);
    out[12 + j] = w;
  }
}

}  // namespace

extern "C" {

// The constants the loader checks against the host's: 2^64 mod p, then blake3's IV.
void tapstark_transcript_constants(uint32_t* out) {
  out[0] = kR2;
  blake3_iv(out + 1);
}

#ifdef __CUDACC__
// One step, one thread; `out` receives 16 words. kind 0: Blake3Compression, 1: TestPermutation.
int tapstark_transcript_step(const uint32_t* cv, const uint32_t* pending, int n_pending, const uint32_t* roots,
                             int reps, long long row_stride, long long col_stride, int kind, uint32_t* out,
                             void* stream) {
  if (n_pending < 0 || n_pending > kMaxPending || reps < 1 || reps > kMaxReps ||
      (kind != kBlake3 && kind != kTestPermutation)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  transcript_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(cv, pending, n_pending, roots, reps,
                                                                       row_stride, col_stride, kind, out);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // extern "C"
