// SHA-256 for the taptree commits on Hopper (sm_90a): the tapleaf
// compressions and TapBranch nodes of tapstark_torch/commit/device_commit.py
// (wrappers and plain versions in tapstark_torch/hashes/sha256_device.py).
//
// Replaces the TPU kernels of tapstark/hashes/sha256_device.py:
//   sha256_compress <- _sha_pallas_kernel (K5): one SHA-256 compression per
//                      lane, word-major (8, M) state and (16, M) block;
//   tapbranch       <- _tapbranch_pallas_kernel (K6): one whole BIP-341
//                      TapBranch node per lane: sort the two child digests,
//                      compress them from the TapBranch tag midstate,
//                      compress the constant padding block (its schedule
//                      folded into 64 K+W constants), feed forward.
// They compute what K5 and K6 compute; the data movement is this card's.
//
// What bounds them: integer instruction issue. A compression is ~1,380
// 32-bit integer instructions (64 rounds of 14 once LOP3, IADD3 and SHF fuse
// them: six funnel-shift rotates, four three-input logic ops, four adds; 48
// schedule words of 10) against 128 bytes of device-memory traffic per lane
// in the plain form (8 + 16 words in, 8 out) and ~35 in the leaf form, whose
// suffix words every repetition shares: 11 to 40 instructions per byte,
// where the card issues ~10 per byte it can move (33.5 T op/s: 132 SMs x
// 128 lanes x 1.98 GHz, over 3.35 TB/s). A TapBranch node is ~2,300
// instructions for 96 bytes. So the least card time is the instruction
// count over 33.5 T op/s: ~41 us per million compressions, ~54 ms for the
// ~1.3e9 compressions of a north-star prove (2^20 rows, blowup 4, 28
// repetitions). Measured on an H100 (chip_smoke.py), both kernels issue at
// about half that rate.
//
// What the design does about it: one lane per thread, 64 rounds unrolled
// with the 16-word schedule window in registers, rotates as funnel shifts,
// no shared memory and no barriers. Words are word-major, so neighbouring
// threads read neighbouring addresses. The leaf form never builds the
// (16 nb, R, N) block tensor: a thread ORs its leaf's shared suffix word
// with its repetition's remainder word as it loads it, and loops over the
// nb suffix blocks from its repetition's head midstate (grid y = the
// repetition, so those words are one broadcast load per warp). TapBranch
// levels are read in natural node order: a thread reads children 2i and
// 2i+1 through strided pointers, which coalesce in word-major rows. The
// TPU's (8, 256) vreg tiling and 2048-lane padding have no counterpart: the
// last block masks its tail.
// Not yet done, for later work: several lanes per thread to hide latency,
// fusing the leaf phase with the first TapBranch levels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

// SHA-256 state after the tagged-hash prefix sha256("TapBranch") twice
// (tag_midstate_words(b"TapBranch")).
__constant__ uint32_t kTapBranchMid[8] = {
    0x23a865a9u, 0xb8a40da7u, 0x977c1e04u, 0xc49e246fu,
    0xb5be1376u, 0x9d24c9b7u, 0xb583b5d4u, 0xa8d226d2u};

// K[i] + W[i] of TapBranch's second block, the constant padding of a
// 64-byte message after the prefix block (_tapbranch_block2_round_consts).
__constant__ uint32_t kTapBranchBlock2[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf574u, 0x649b69c1u, 0xf23e4787u,
    0x0fe1edc6u, 0x240ca2dcu, 0x4fe9346fu, 0x4b1e84aau, 0x61b9431eu, 0x36f9b39au,
    0xfa465156u, 0xb85a8e77u, 0xb01d681du, 0x5e59c7eau, 0x2faa3291u, 0x07e2a6fbu,
    0x1f515a8eu, 0x6f915f0au, 0x5fb4221du, 0x612cc90au, 0x35c3e883u, 0xa925d9d4u,
    0x8b82d1b9u, 0x92848088u, 0x9a5b7704u, 0x034ba272u, 0x9f594686u, 0x6f480592u,
    0xe49bee62u, 0xc1cf12ebu, 0x3ef55e11u, 0x1f0f59a3u, 0x327a0634u, 0xbfa4d9bcu,
    0x770df572u, 0x9b9fbf40u, 0xc21be9e9u, 0xf5001d69u, 0x840ec6dau, 0x8a337f83u,
    0xb737625au, 0xe9b9ecd0u, 0xfe5d6d40u, 0xa52dab8du, 0xee944592u, 0x5f2d004au,
    0x3bc8cb2eu, 0x36d964a4u, 0x5eb10cafu, 0x6289d971u};

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One round; kw = K[i] + W[i]. The caller's unrolled loop renames the
// eight registers instead of moving them.
__device__ __forceinline__ void sha_round(uint32_t s[8], uint32_t kw) {
  const uint32_t e = s[4], a = s[0];
  const uint32_t t1 =
      s[7] + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & s[5]) ^ (~e & s[6])) + kw;
  const uint32_t t2 =
      (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & s[1]) ^ (a & s[2]) ^ (s[1] & s[2]));
  s[7] = s[6];
  s[6] = s[5];
  s[5] = e;
  s[4] = s[3] + t1;
  s[3] = s[2];
  s[2] = s[1];
  s[1] = a;
  s[0] = t1 + t2;
}

// st <- compress(st, w); w is overwritten by the schedule window.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = st[k];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      w[i & 15] += (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)) + w[(i - 7) & 15] +
                   (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10));
    }
    sha_round(s, kK[i] + w[i & 15]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] += s[k];
}

// Lane (r, n): state word k at state[k*st_word + r*st_rep + n*st_lane];
// block b's word j at block[(16b + j) * n_lanes + n], ORed with
// rem[(16b + j) * reps + r] when rem is given. Out (8, reps, n_lanes).
// Grid: x over n, y = r.
__global__ void __launch_bounds__(kThreads) sha256_compress_kernel(
    const uint32_t* __restrict__ state, long long st_word, long long st_rep,
    long long st_lane, const uint32_t* __restrict__ block, long long n_lanes,
    const uint32_t* __restrict__ rem, int reps, int nb, uint32_t* __restrict__ out) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= n_lanes) return;
  const int r = blockIdx.y;
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = state[k * st_word + r * st_rep + n * st_lane];
  for (int b = 0; b < nb; ++b) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long row = 16ll * b + j;
      w[j] = block[row * n_lanes + n] | (rem ? rem[row * reps + r] : 0u);
    }
    compress(st, w);
  }
  const long long m = static_cast<long long>(reps) * n_lanes;
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * m + r * n_lanes + n] = st[k];
}

// Lane i: children h1[k*h1_word + i*h1_lane], h2[...] -> out[k*m + i].
__global__ void __launch_bounds__(kThreads) tapbranch_kernel(
    const uint32_t* __restrict__ h1, long long h1_word, long long h1_lane,
    const uint32_t* __restrict__ h2, long long h2_word, long long h2_lane, long long m,
    uint32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t x[8], y[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = h1[k * h1_word + i * h1_lane];
    y[k] = h2[k * h2_word + i * h2_lane];
  }
  // lexicographic order of big-endian digests = order of their word arrays
  bool less = false, decided = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    less = less || (!decided && x[k] < y[k]);
    decided = decided || x[k] != y[k];
  }
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    w[k] = less ? x[k] : y[k];
    w[k + 8] = less ? y[k] : x[k];
  }
  uint32_t st[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] = kTapBranchMid[k];
  compress(st, w);
  uint32_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = st[k];
#pragma unroll
  for (int j = 0; j < 64; ++j) sha_round(s, kTapBranchBlock2[j]);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k * m + i] = st[k] + s[k];
}

unsigned grid_x(long long lanes) {
  return static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// The constants as compiled, so the loader can check them against the
// host's: out[0:8] TapBranch midstate, out[8:72] its second block's K+W,
// out[72:136] K. Returns a CUDA error code.
int tapstark_sha256_constants(uint32_t* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, kTapBranchMid, sizeof(kTapBranchMid));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 8, kTapBranchBlock2, sizeof(kTapBranchBlock2));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 72, kK, sizeof(kK));
  return static_cast<int>(e);
}

int tapstark_sha256_compress(const uint32_t* state, long long st_word, long long st_rep,
                             long long st_lane, const uint32_t* block, long long n_lanes,
                             const uint32_t* rem, int reps, int nb, uint32_t* out,
                             void* stream) {
  if (n_lanes == 0) return 0;
  sha256_compress_kernel<<<dim3(grid_x(n_lanes), reps), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      state, st_word, st_rep, st_lane, block, n_lanes, rem, reps, nb, out);
  return static_cast<int>(cudaGetLastError());
}

int tapstark_tapbranch(const uint32_t* h1, long long h1_word, long long h1_lane,
                       const uint32_t* h2, long long h2_word, long long h2_lane, long long m,
                       uint32_t* out, void* stream) {
  if (m == 0) return 0;
  tapbranch_kernel<<<grid_x(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h1, h1_word, h1_lane, h2, h2_word, h2_lane, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
