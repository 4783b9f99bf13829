// Exact modular DFT-matrix product on Hopper's int8 tensor cores (sm_90a):
// the member transform of the limb-matmul NTT
// (tapstark_torch/poly/matmul_ntt.py).
//
// Replaces the TPU kernel of tapstark/poly/matmul_ntt.py:
//   limb_matmul <- _fused_kernel / _fused_kernel_tw (K7, via
//                  mod_matmul_fused): out = W (R x R) @ x (R x B) mod p for
//                  canonical x, optionally times an (R, B) Montgomery
//                  twiddle in the epilogue.
//
// Arithmetic. W and x are split into five 7-bit limbs (int8, 0..127), and
// the 25 limb products W_a @ x_b are summed into 9 int32 buckets by shift
// s = a + b. A bucket stays below R * 127^2 * 5 < 2^31 for R <= 128, so the
// int32 tensor-core sums are exact; R > 128 is refused. The buckets are
// recombined as sum_s mont_mul(S_s, mont(2^(7s))), a canonical value in
// [0, p), then multiplied by the Montgomery twiddle if one is given, so the
// words equal the TPU's.
//
// What bounds it. At R = 128 the dots are 25 * R^2 * B int8 MACs, a few
// microseconds at the card's dense int8 rate for the B = 2^14 of the check
// shape; the epilogue is ~100 integer instructions per output (nine
// Montgomery products and adds, the twiddle), and the bytes are 8-12 per
// output. All three roofs are within a factor of a few of each other, so
// no single one sets the time of this simple kernel: the shared-memory
// fragment loads and the serial bucket loop do.
//
// What the design does about it. A block of 8 warps takes all R rows and
// 64 columns of x. It copies W's five limb planes (80 KiB at R = 128) and
// the five limb planes of its x tile (40 KiB) into shared memory, both in
// 16 x 16 sub-tiles stored contiguously, so every wmma fragment load is
// 256-byte aligned with a 16-byte stride. Each warp owns 16 x 16 output
// tiles; for each it runs the 9 buckets in turn, each bucket's limb dots
// into one int32 accumulator fragment (m16n16k16, signed char), and folds
// the bucket into a modular accumulator fragment of the same layout at
// once, so the nine buckets never leave registers. The finished tile goes
// through a per-warp 1 KiB staging buffer to device memory, with the
// twiddle multiply on the way. R < 16 (the recursion's small members) is
// zero-padded to 16, which is exact.
// Not yet done, for later work: wgmma with TMA-fed tiles, W kept resident
// across column tiles by a persistent block, fewer limbs.

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

#include "babybear.cuh"

namespace {

using namespace nvcuda;

constexpr int kLimbBits = 7;
constexpr int kLimbs = 5;
constexpr int kBuckets = 2 * kLimbs - 1;
constexpr int kMaxLogR = 7;
constexpr int kTileB = 64;  // x columns per block
constexpr int kWarps = 8;

// mont(2^(7s)) for s = 0 .. 8: mont_mul(S, c_s) = S * 2^(7s) mod p, canonical.
__constant__ uint32_t kShiftMont[kBuckets] = {
    0xffffffeu, 0x7fffeefu, 0x3fff7778u, 0x1fbbbbbcu, 0x65dddddfu,
    0x4eeeef14u, 0x177789acu, 0x3c4d5e7u, 0x26af37cu,
};

// Offset of element (row, col) in a matrix stored as contiguous 16 x 16
// sub-tiles, `tiles_c` sub-tiles per sub-tile row.
__device__ __forceinline__ int tiled(int row, int col, int tiles_c) {
  return ((row >> 4) * tiles_c + (col >> 4)) * 256 + (row & 15) * 16 + (col & 15);
}

__global__ void __launch_bounds__(kWarps * 32)
    limb_matmul_kernel(const int8_t* __restrict__ w_limbs, const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ tw, uint32_t* __restrict__ out, int r, int rp,
                       long long b) {
  extern __shared__ __align__(256) unsigned char smem[];
  const int tiles_r = rp >> 4;
  constexpr int tiles_c = kTileB >> 4;
  signed char* sw = reinterpret_cast<signed char*>(smem);  // [limb][R tiles][K tiles][16][16]
  signed char* sx = sw + kLimbs * rp * rp;                  // [limb][K tiles][B tiles][16][16]
  int* stage = reinterpret_cast<int*>(sx + kLimbs * rp * kTileB);  // [warp][16][16]
  const long long col0 = static_cast<long long>(blockIdx.x) * kTileB;

  for (int i = threadIdx.x; i < kLimbs * rp * rp; i += blockDim.x) {
    const int l = i / (rp * rp);
    const int rem = i - l * rp * rp;
    const int row = rem / rp, col = rem - row * rp;
    const signed char v = (row < r && col < r) ? w_limbs[(l * r + row) * r + col] : 0;
    sw[l * rp * rp + tiled(row, col, tiles_r)] = v;
  }
  for (int i = threadIdx.x; i < rp * kTileB; i += blockDim.x) {
    const int row = i / kTileB, col = i - row * kTileB;
    const long long c = col0 + col;
    const uint32_t v = (row < r && c < b) ? x[row * b + c] : 0u;
    const int off = tiled(row, col, tiles_c);
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      sx[l * rp * kTileB + off] = static_cast<signed char>((v >> (kLimbBits * l)) & 0x7fu);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* st = stage + warp * 256;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> bucket, acc;
  for (int t = warp; t < tiles_r * tiles_c; t += kWarps) {
    const int ti = t / tiles_c, tj = t - ti * tiles_c;
    wmma::fill_fragment(acc, 0);
    for (int s = 0; s < kBuckets; ++s) {
      wmma::fill_fragment(bucket, 0);
      const int a_lo = s > kLimbs - 1 ? s - (kLimbs - 1) : 0;
      const int a_hi = s < kLimbs - 1 ? s : kLimbs - 1;
      for (int a = a_lo; a <= a_hi; ++a) {
        const signed char* wa = sw + a * rp * rp + ti * tiles_r * 256;
        const signed char* xb = sx + (s - a) * rp * kTileB + tj * 256;
        for (int kk = 0; kk < tiles_r; ++kk) {
          wmma::load_matrix_sync(fa, wa + kk * 256, 16);
          wmma::load_matrix_sync(fb, xb + kk * tiles_c * 256, 16);
          wmma::mma_sync(bucket, fa, fb, bucket);
        }
      }
      const uint32_t c = kShiftMont[s];
#pragma unroll
      for (int e = 0; e < bucket.num_elements; ++e) {
        acc.x[e] = static_cast<int>(
            add_mod(static_cast<uint32_t>(acc.x[e]), mont_mul(static_cast<uint32_t>(bucket.x[e]), c)));
      }
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = ti * 16 + (e >> 4);
      const long long c = col0 + tj * 16 + (e & 15);
      if (row < r && c < b) {
        uint32_t v = static_cast<uint32_t>(st[e]);
        if (tw) v = mont_mul(v, tw[row * b + c]);
        out[row * b + c] = v;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// p, MU and the nine shift constants as compiled (out: 11 words), so the
// loader can check them against the host's; returns a CUDA error code.
int tapstark_matmul_constants(uint32_t* out) {
  out[0] = kP;
  out[1] = kMu;
  return static_cast<int>(cudaMemcpyFromSymbol(out + 2, kShiftMont, sizeof(kShiftMont)));
}

// w_limbs: (5, 2^log_r, 2^log_r) int8 limb planes of the DFT matrix;
// x: (2^log_r, b) canonical uint32; tw: (2^log_r, b) Montgomery twiddles
// or null; out: (2^log_r, b) canonical uint32, distinct from x.
int tapstark_limb_matmul(const int8_t* w_limbs, const uint32_t* x, const uint32_t* tw,
                         uint32_t* out, int log_r, long long b, void* stream) {
  if (log_r < 0 || log_r > kMaxLogR || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int r = 1 << log_r;
  const int rp = r < 16 ? 16 : r;
  const size_t smem = static_cast<size_t>(kLimbs) * rp * rp + static_cast<size_t>(kLimbs) * rp * kTileB +
                      kWarps * 256 * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(limb_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (b + kTileB - 1) / kTileB;
  limb_matmul_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(w_limbs, x, tw, out, r, rp, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
