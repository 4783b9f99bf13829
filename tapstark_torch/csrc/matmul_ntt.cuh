// The index math and arithmetic of the limb-matmul kernel (matmul_ntt.cu):
// the kernel uses these functions on the card, and
// tests/cuda_host_shim/matmul_host.cpp builds them with g++ (against
// stand-ins for the CUDA built-ins) and runs the kernel's data flow on the
// host around a model of the tensor-core instruction. Those that use a
// built-in (__byte_perm, __umulhi) are __device__; the rest are
// __host__ __device__.
//
// The product. out = W (R x R) @ x (R x B) mod p is computed as its
// transpose, out^T = x^T W^T: a GEMM with M = B (columns of x), N = R
// (output rows k), K = R (input rows i). For 8-bit types wgmma reads only
// K-major operands from shared memory, and W as stored (row k, inputs i
// contiguous) is the K-major B operand, so W needs no transpose. x^T is
// the A operand, built in registers: a consumer thread reads the words of
// x it needs and turns them into byte-limb fragments with byte permutes,
// so no limb plane of x ever lands in shared memory.
//
// Byte limbs. W and x are split into four u8 limbs (values < 2^31 < 2^32).
// The 16 products W_b @ x_a are summed into 7 s32 buckets by shift
// s = a + b; a bucket is at most 4 * 255^2 * 128 = 33,292,800 < 2^25 for
// R <= 128, so the tensor-core sums are exact.
//
// One reduction. With c_s = mont(2^(8s)) = 2^(8s) * 2^32 mod p, the 64-bit
// T = sum_s S_s * c_s stays below 7 * 2^25 * p < 2^59 < p * 2^32, so one
// Montgomery reduction of T and one conditional subtract give the
// canonical sum_s S_s * 2^(8s) mod p = (W @ x) mod p.
//
// Layouts (all offsets from 1024-byte aligned bases, 128-byte swizzle:
// the 16-byte chunk c of 128-byte row q lies at chunk c ^ (q % 8)).
// - W: 4 limb planes of RP rows (k) x 128 bytes (i), RP = max(R, 16), zero
//   padded in k and i; built on the host (matmul_ntt.py w_matrix_smem).
// - x, one stage: 64 columns j0 .. j0+63 as two TMA boxes of 32 columns,
//   each RP rows (i) x 128 bytes (32 words); rows >= R are never read into
//   a product (W's columns there are zero).
// - A fragment: warp q of a consumer warpgroup owns fragment rows
//   16q .. 16q+15; lane (g, t) = (lane / 4, lane % 4) holds rows g and g+8,
//   which are the tile's columns j = 16q + 2g and 16q + 2g + 1 (so each
//   thread reads its two words of a row as one 8-byte load), and K
//   bytes 4t .. 4t+3 (registers 0, 1) and 16 + 4t .. (registers 2, 3) of
//   each 32-deep step.
// - Accumulators: register 4n + e (e < 4) of lane (g, t) of warp q holds
//   fragment row 16q + g + 8 * (e / 2) and column 8n + 2t + e % 2 of the
//   half of N (RP / 2 output rows) being computed.

#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace {

constexpr int kLimbs = 4;
constexpr int kBuckets = 2 * kLimbs - 1;
constexpr int kMaxLogR = 7;
constexpr int kTileCols = 64;  // columns of x per tile (M of a warpgroup)
constexpr int kBoxCols = 32;   // columns of one TMA box: 128 bytes

// mont(2^(8s)) for s = 0 .. 6, baked; the loader checks them against
// matmul_ntt.py byte_shift_consts_mont.
__host__ __device__ constexpr uint32_t byte_shift_mont(int s) {
  return s == 0   ? 0x0ffffffeu
         : s == 1 ? 0x0ffffddeu
         : s == 2 ? 0x0ffddddeu
         : s == 3 ? 0x0ddddddeu
         : s == 4 ? 0x45dddde3u
         : s == 5 ? 0x05dde26bu
                  : 0x3de26af4u;
}

// The padded row count and the K steps of 32 for R = 2^log_r.
__host__ __device__ constexpr int padded_rows(int r) { return r < 16 ? 16 : r; }
__host__ __device__ constexpr int k_steps(int rp) { return (rp + 31) / 32; }

// Byte limbs of four words: limb[a] holds byte a of w0, w1, w2, w3 in its
// bytes 0, 1, 2, 3 (a 4 x 4 byte transpose, eight byte permutes).
__device__ __forceinline__ void byte_limbs(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t (&limb)[kLimbs]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140u);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362u);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140u);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362u);
  limb[0] = __byte_perm(t0, t2, 0x5410u);
  limb[1] = __byte_perm(t0, t2, 0x7632u);
  limb[2] = __byte_perm(t1, t3, 0x5410u);
  limb[3] = __byte_perm(t1, t3, 0x7632u);
}

// T + S_s * c_s: one wide multiply-add per bucket.
__host__ __device__ __forceinline__ uint64_t fold_bucket(uint64_t t, uint32_t bucket, uint32_t c) {
  return t + static_cast<uint64_t>(bucket) * c;
}

// T * 2^-32 mod p, canonical, for T < p * 2^32: the one reduction.
__device__ __forceinline__ uint32_t redc64(uint64_t t) {
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t hi = static_cast<uint32_t>(t >> 32);
  const uint32_t m = lo * kMu;
  const uint32_t u = hi + __umulhi(m, kP) + (lo != 0u);
  return u >= kP ? u - kP : u;
}

// Word offset of x's (row i, tile column j) in a stage (j < 64).
__host__ __device__ __forceinline__ int x_stage_word(int rp, int i, int j) {
  const int box = j / kBoxCols, jj = j % kBoxCols;
  return box * rp * kBoxCols + i * kBoxCols + ((((jj >> 2) ^ (i & 7)) << 2) | (jj & 3));
}

// Byte offset of W's (row k, input i) in one limb plane.
__host__ __device__ __forceinline__ int w_plane_byte(int k, int i) {
  return k * 128 + ((((i >> 4) ^ (k & 7)) << 4) | (i & 15));
}

// The A fragments of lane `lane` of warp `q` of a consumer warpgroup, for
// every K step and limb, from one stage of x.
template <int RP>
__device__ __forceinline__ void load_a_frags(const uint32_t* stage, int q, int lane,
                                             uint32_t (&frag)[k_steps(RP)][kLimbs][4]) {
  const int g = lane >> 2, t = lane & 3;
  const int j = 16 * q + 2 * g;
#pragma unroll
  for (int kk = 0; kk < k_steps(RP); ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 32 * kk + 16 * half + 4 * t + c;
        if (i < RP) {
          const uint2 v = *reinterpret_cast<const uint2*>(stage + x_stage_word(RP, i, j));
          lo[c] = v.x;
          hi[c] = v.y;
        } else {
          lo[c] = hi[c] = 0u;
        }
      }
      uint32_t llo[kLimbs], lhi[kLimbs];
      byte_limbs(lo[0], lo[1], lo[2], lo[3], llo);
      byte_limbs(hi[0], hi[1], hi[2], hi[3], lhi);
#pragma unroll
      for (int a = 0; a < kLimbs; ++a) {
        frag[kk][a][2 * half] = llo[a];
        frag[kk][a][2 * half + 1] = lhi[a];
      }
    }
  }
}

// Tile column j and output row k of accumulator register e of lane `lane`
// of warp q of a consumer warpgroup, computing half `half` of the output
// rows (nwg = RP / 2 of them).
__host__ __device__ __forceinline__ void acc_coords(int nwg, int half, int q, int lane, int e, int& j, int& k) {
  const int g = lane >> 2, t = lane & 3;
  j = 16 * q + 2 * g + ((e >> 1) & 1);
  k = half * nwg + 8 * (e >> 2) + 2 * t + (e & 1);
}

// Where output (k, j) goes: index base + k * stride. Natural form
// (width 0): the (R, B) matrix. Transposed form: B = C * width columns
// j = i2 * width + wi, written as the next level's (C, R * width) matrix,
// element (i2, k * width + wi).
struct OutMap {
  long long base, stride;
};

__host__ __device__ __forceinline__ OutMap out_map(long long j, long long b, int r, int width) {
  if (width == 0) return {j, b};
  return {(j / width) * r * width + j % width, width};
}

}  // namespace
