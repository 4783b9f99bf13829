// SHA-256 for the taptree commits on Hopper (sm_90a): the tapleaf digests
// and TapBranch levels of tapstark_torch/commit/device_commit.py (wrappers
// and plain versions in tapstark_torch/hashes/sha256_device.py).
//
// Replaces the TPU kernels of tapstark/hashes/sha256_device.py:
//   tapleaf_subtrees <- _sha_pallas_kernel (K5): the leaf compressions,
//                       fused with the first TapBranch levels above them;
//   tapbranch_levels <- _tapbranch_pallas_kernel (K6): BIP-341 TapBranch
//                       nodes (sort the two child digests, compress them from
//                       the TapBranch tag midstate, compress the constant
//                       padding block, its schedule folded into 64 K+W
//                       constants, feed forward), several levels per launch.
// They compute what K5 and K6 compute; the data movement is this card's.
//
// What bounds them: integer instruction issue, on two pipes of 64 lanes per
// SM per clock. A compression is 1,384 32-bit integer instructions: 64
// rounds of four LOP3, six rotates and four adds; 48 schedule words of two
// LOP3, four rotates, two shifts and two adds; eight feed-forward adds.
// LOP3 issues only on the ALU pipe. A rotate is a funnel shift (SHF, ALU
// pipe) or two IMADs on the FMA pipe (x * 2^(32-n) + mulhi(x, 2^(32-n))),
// a shift an SHF or one IMAD.HI, an add an IADD3 (ALU) or an IMAD (FMA).
// Split between the pipes at best, the ALU pipe issues ~771 instructions a
// compression and ~1,301 a TapBranch node, over 16.7 T op/s (132 SMs x 64
// x 1.98 GHz): the bound chip_smoke.py states. This build issues every
// rotate and shift on the ALU pipe, 1,024 a compression and 1,688 a node.
// Device memory is far behind: the leaf form moves ~35 bytes a compression.
//
// What the design does about it:
// - Levels the commit throws away never reach device memory. A
//   tapleaf_subtrees block of 512 threads hashes 2048 adjacent leaves
//   (four a thread), keeps the digests in shared memory and hashes the
//   TapBranch levels above them there (the commit asks for 4: 1024, 512,
//   256, 128 nodes; every thread busy on the first two); only the top level
//   is written, 2 bytes per leaf lane at 4 levels. A tapbranch_levels block
//   reads 2048 children (of one repetition, or several whole repetitions at
//   the top of a tree) and hashes up to 11 levels in shared memory, writing
//   each level from write_first up in natural node order at its own offset
//   in the commit's (8, R, T) buffer: one launch takes levels 4 -> 8
//   (writing level 8 only), then one launch per 4 levels up to the root. A
//   2^22-leaf tree takes 6 launches, not 23. The first tiling, 512 leaves a
//   block and one node a thread, left most threads idle on the top levels
//   and ran slower at full shape.
// - Shared memory holds a level split into even and odd nodes (node i at
//   half i & 1, index i >> 1, the odd half 16 banks on): thread t reads
//   children 2t and 2t+1 and writes node t without bank conflicts. Levels
//   alternate between two buffers (96 KiB a block with both, set above the
//   48 KiB default per launch), so a level never overwrites its children.
// - The instruction mix: a TapBranch node's adds go to the FMA pipe as
//   IMADs (the 1 is read from constant memory so that ptxas keeps the
//   IMAD); the leaf compressions keep ptxas's IADD3s; every rotate and shift
//   is a funnel shift. Builds that also moved the leaf adds, or some rotates
//   and shifts, onto the FMA pipe ran no faster at full shape on an H100.
//   The kernels' static SASS by class: chip_study.py sass.
// - One lane per thread, 64 rounds unrolled with the 16-word schedule window
//   in registers; words word-major, so neighbouring threads read
//   neighbouring addresses. Offsets into device memory are 64-bit (28 x
//   2^24 lanes x 8 words exceeds 2^31); lane and node indices are 32-bit,
//   a launch taking fewer than 2^31 (cheaper address arithmetic in the leaf
//   compressions than 64-bit indices). ptxas: no spills (chip_smoke.py
//   fails on one).
// Not yet done, for later work: several lanes per thread to hide latency;
// the first rounds of a leaf's suffix compression, whose words are its
// repetition's alone, hashed once per repetition; an instruction mix nearer
// the best split of the bound.

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

constexpr int kTile = 2048;       // leaves or children a block takes
constexpr int kThreads = 512;     // threads of a block
constexpr int kLeafLevels = 4;    // levels the commit's leaf launch hashes
constexpr int kMaxTileLevels = 11;  // 2048 -> 1

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {  // ALU pipe
  return __funnelshift_r(x, x, n);
}

__constant__ uint32_t kOne = 1;

// a + b as an IMAD on the FMA pipe (a * 1 + b; the 1 from constant memory,
// so that ptxas cannot turn it back into an IADD3).
__device__ __forceinline__ uint32_t add_fma(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(kOne), "r"(b));
  return d;
}

template <bool kFma>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return kFma ? add_fma(a, b) : a + b;
}

__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}

__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}

__device__ __forceinline__ uint32_t small_sigma0(uint32_t w) {
  return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3);
}

__device__ __forceinline__ uint32_t small_sigma1(uint32_t w) {
  return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10);
}

// One round; kw = K[i] + W[i]. The caller's unrolled loop renames the
// eight registers instead of moving them.
template <bool kFma>
__device__ __forceinline__ void sha_round(uint32_t s[8], uint32_t kw) {
  const uint32_t e = s[4], a = s[0];
  const uint32_t t1 = add<kFma>(add<kFma>(add<kFma>(s[7], big_sigma1(e)), (e & s[5]) ^ (~e & s[6])), kw);
  const uint32_t t2 = add<kFma>(big_sigma0(a), (a & s[1]) ^ (a & s[2]) ^ (s[1] & s[2]));
  s[7] = s[6];
  s[6] = s[5];
  s[5] = e;
  s[4] = add<kFma>(s[3], t1);
  s[3] = s[2];
  s[2] = s[1];
  s[1] = a;
  s[0] = add<kFma>(t1, t2);
}

// st <- compress(st, w); w is overwritten by the schedule window. kFma puts
// the adds of the rounds and the schedule on the FMA pipe.
template <bool kFma>
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = st[k];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      w[i & 15] = add<kFma>(add<kFma>(add<kFma>(w[i & 15], small_sigma0(w[(i - 15) & 15])), w[(i - 7) & 15]),
                            small_sigma1(w[(i - 2) & 15]));
    }
    sha_round<kFma>(s, add<kFma>(kK[i], w[i & 15]));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) st[k] += s[k];
}

// d <- TapBranch(x, y): the two digests sorted, then two compressions, their
// adds on the FMA pipe.
__device__ __forceinline__ void tapbranch(const uint32_t x[8], const uint32_t y[8], uint32_t d[8]) {
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
  compress<true>(st, w);
  uint32_t s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = st[k];
#pragma unroll
  for (int j = 0; j < 64; ++j) sha_round<true>(s, kTapBranchBlock2[j]);
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = st[k] + s[k];
}

// A tree level in device memory: node j of repetition r has word k at
// p[k * word + r * rep + j]; its repetitions hold 1 << log_n nodes each.
struct Level {
  uint32_t* p;
  long long word, rep;
  int log_n;
};

// A level of up to 2 * half nodes in shared memory: word k of node i at
// (i & 1) * (8 * half + 16) + k * half + (i >> 1). The odd half starts 16
// banks after the even one.
__device__ __forceinline__ int slot(int i, int k, int half) {
  return (i & 1) * (8 * half + 16) + k * half + (i >> 1);
}

__host__ __device__ constexpr int smem_words(int nodes) { return 8 * nodes + 16; }

// Shared memory of a block: level 0 in A (kTile nodes), then the levels
// alternate between B (kTile / 2) and A, so no level overwrites the one it
// reads.
constexpr size_t kSmemLevels = 4 * (smem_words(kTile) + smem_words(kTile / 2));

// Node and lane indices are 32-bit (a launch takes fewer than 2^31 nodes);
// offsets into device memory are 64-bit.

// Hash `levels` TapBranch levels over the tile's nodes in shared memory
// (level 0: flattened nodes tile0 .. tile0 + kTile - 1 of m0, each
// repetition holding 1 << log_n0 of them, stored in A). Thread t takes
// nodes t, t + kThreads, ... of each level. Levels write_first .. levels
// go to `out`, each after the one below it along a repetition's row.
__device__ __forceinline__ void hash_levels(uint32_t* sm, int tile0, int m0, int log_n0, int levels,
                                            int write_first, Level out) {
  uint32_t* src = sm;
  uint32_t* dst = sm + smem_words(kTile);
  long long off = 0;  // this level's column in out
  for (int l = 1; l <= levels; ++l) {
    const int cnt = kTile >> l;
    const int first = tile0 >> l, end = m0 >> l;  // the level's flattened nodes
    const int log_n = log_n0 - l;
#pragma unroll 1
    for (int i = threadIdx.x; i < cnt && first + i < end; i += kThreads) {
      uint32_t x[8], y[8], d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x[k] = src[slot(2 * i, k, cnt)];
        y[k] = src[slot(2 * i + 1, k, cnt)];
      }
      tapbranch(x, y, d);
      if (l < levels) {
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[slot(i, k, cnt / 2)] = d[k];
      }
      if (l >= write_first) {
        const int g = first + i, r = g >> log_n, j = g & ((1 << log_n) - 1);
        uint32_t* o = out.p + r * out.rep + off + j;
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k * out.word] = d[k];
      }
    }
    if (l >= write_first) off += 1ll << log_n;
    if (l < levels) {
      __syncthreads();
      uint32_t* t = src;
      src = dst;
      dst = t;
    }
  }
}

// Lane f = r * N + n (N = 1 << log_n): the tapleaf digest of leaf n of
// repetition r, from midstate mids[k * reps + r] over the nb blocks whose
// word j is suffix[j * N + n] | rem[j * reps + r]; then `levels` TapBranch
// levels over the block's kTile lanes. Writes the top level into out.
__global__ void __launch_bounds__(kThreads, 2) tapleaf_subtrees_kernel(
    const uint32_t* __restrict__ mids, const uint32_t* __restrict__ suffix,
    const uint32_t* __restrict__ rem, int reps, int log_n, int nb, int levels, Level out) {
  extern __shared__ uint32_t sm[];
  const int tile0 = blockIdx.x * kTile;
  const int m0 = reps << log_n;
#pragma unroll 1
  for (int i = threadIdx.x; i < kTile && tile0 + i < m0; i += kThreads) {
    const int f = tile0 + i, r = f >> log_n, n = f & ((1 << log_n) - 1);
    uint32_t st[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) st[k] = mids[k * reps + r];
    const uint32_t* sp = suffix + n;
    const uint32_t* rp = rem + r;
#pragma unroll 1
    for (int b = 0; b < nb; ++b) {
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        w[j] = *sp | *rp;
        sp += 1ll << log_n;
        rp += reps;
      }
      compress<false>(st, w);
    }
    if (levels == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) out.p[k * out.word + r * out.rep + n] = st[k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) sm[slot(i, k, kTile / 2)] = st[k];
    }
  }
  if (levels == 0) return;
  __syncthreads();
  hash_levels(sm, tile0, m0, log_n, levels, levels, out);
}

// The level `in` (m0 = reps << in.log_n nodes): `levels` TapBranch levels
// over each block's kTile children; levels write_first .. levels to out.
__global__ void __launch_bounds__(kThreads, 2) tapbranch_levels_kernel(
    Level in, int m0, int levels, int write_first, Level out) {
  extern __shared__ uint32_t sm[];
  const int tile0 = blockIdx.x * kTile;
  const int mask = (1 << in.log_n) - 1;
#pragma unroll 1
  for (int i = threadIdx.x; i < kTile && tile0 + i < m0; i += kThreads) {
    const int f = tile0 + i;
    const uint32_t* src = in.p + (f >> in.log_n) * in.rep + (f & mask);
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[slot(i, k, kTile / 2)] = src[k * in.word];
  }
  __syncthreads();
  hash_levels(sm, tile0, m0, in.log_n, levels, write_first, out);
}

unsigned blocks(long long items) {
  return static_cast<unsigned>((items + kTile - 1) / kTile);
}

// Shared memory a launch needs: none for the leaves alone, level 0 for a
// single level, both buffers otherwise; above the 48 KiB default, so each
// launch allows the kernel that much first.
size_t smem_bytes(int levels) {
  return levels == 0 ? 0 : levels == 1 ? 4 * smem_words(kTile) : kSmemLevels;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
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

// The tiling as compiled: tile, the leaf launch's levels, threads, most
// levels per launch.
void tapstark_sha256_tiling(int* out) {
  out[0] = kTile;
  out[1] = kLeafLevels;
  out[2] = kThreads;
  out[3] = kMaxTileLevels;
}

int tapstark_tapleaf_subtrees(const uint32_t* mids, const uint32_t* suffix, const uint32_t* rem,
                              int reps, int log_n, int nb, int levels, uint32_t* out,
                              long long out_word, long long out_rep, void* stream) {
  const long long lanes = static_cast<long long>(reps) << log_n;
  if (lanes == 0) return 0;
  if (lanes > INT32_MAX || levels < 0 || levels > kMaxTileLevels || levels > log_n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(tapleaf_subtrees_kernel, smem_bytes(levels));
  if (e != cudaSuccess) return static_cast<int>(e);
  tapleaf_subtrees_kernel<<<blocks(lanes), kThreads, smem_bytes(levels), static_cast<cudaStream_t>(stream)>>>(
      mids, suffix, rem, reps, log_n, nb, levels, Level{out, out_word, out_rep, log_n - levels});
  return static_cast<int>(cudaGetLastError());
}

int tapstark_tapbranch_levels(const uint32_t* in, long long in_word, long long in_rep, int reps,
                              int log_n, int levels, int write_first, uint32_t* out,
                              long long out_word, long long out_rep, void* stream) {
  const long long m0 = static_cast<long long>(reps) << log_n;
  if (m0 == 0) return 0;
  if (m0 > INT32_MAX || levels < 1 || levels > kMaxTileLevels || levels > log_n || write_first < 1 ||
      write_first > levels)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(tapbranch_levels_kernel, smem_bytes(levels));
  if (e != cudaSuccess) return static_cast<int>(e);
  tapbranch_levels_kernel<<<blocks(m0), kThreads, smem_bytes(levels), static_cast<cudaStream_t>(stream)>>>(
      Level{const_cast<uint32_t*>(in), in_word, in_rep, log_n}, static_cast<int>(m0), levels, write_first,
      Level{out, out_word, out_rep, log_n - write_first});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
