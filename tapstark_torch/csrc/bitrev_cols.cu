// The quotient's coset by columns on Hopper (sm_90a): the first m rows of a
// bit-reversed LDE (R, w) row-major, bit-reversed back to natural order and
// written by columns, dst[j * m + i] = src[rev(i) * w + j]. Wrapped by
// tapstark_torch/poly/ntt.py bit_reverse_cols, which
// fri/pcs.py get_evaluations_on_domain calls on the card; its plain version
// is bit_reverse_rows then a transpose.
//
// Replaces no Pallas kernel: the JAX package gathers the rows
// (tapstark/fri/pcs.py:191 get_evaluations_on_domain, bit_reverse_rows).
// The quotient kernels read the coset by columns (csrc/quotient.cuh), so
// the port's gather also transposes.
//
// What bounds it: bytes, the m * w words read once and written once. The
// design, both sides coalesced:
// - at 32 columns or more, a block moves a 32 x 32 tile (rows x columns)
//   through shared memory: its warps read 32 columns of one source row (a
//   128-byte line; the rows rev(i) of a tile lie apart, each line whole)
//   and write 32 consecutive rows of one destination column;
// - at up to kNarrowMax columns (a row of a few words), a block takes the
//   32 x 32 source rows whose middle log m - 10 bits are its own: with r =
//   a * 2^(log m - 5) + mid * 32 + c, rev(r) = rev(c) * 2^(log m - 5) +
//   rev(mid) * 32 + rev(a), so for each a it reads 32 consecutive rows c,
//   and for each c and column it writes 32 consecutive destination words.
// chip_study.py gather builds this file a second time with
// -DTAPSTARK_BITREV_NARROW_MAX=0 (the tile kernel at every width) to time
// the two forms side by side.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // a block of 32 x 8 threads, each moving 4 words

__global__ void __launch_bounds__(kTile * kTileRows)
    bitrev_cols_kernel(const uint32_t* __restrict__ src, int width, int log_m, uint32_t* __restrict__ dst) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const long long m = 1ll << log_m;
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile;
  const int j0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < kTile; r += kTileRows) {
    const long long i = i0 + r;
    if (i < m && j0 + tx < width) {
      const unsigned long long rev = static_cast<unsigned long long>(__brev(static_cast<unsigned>(i))) >> (32 - log_m);
      tile[r][tx] = src[static_cast<long long>(rev) * width + j0 + tx];
    }
  }
  __syncthreads();
  for (int c = ty; c < kTile; c += kTileRows) {
    if (j0 + c < width && i0 + tx < m) dst[static_cast<long long>(j0 + c) * m + i0 + tx] = tile[tx][c];
  }
}

#ifndef TAPSTARK_BITREV_NARROW_MAX
#define TAPSTARK_BITREV_NARROW_MAX 8
#endif
constexpr int kNarrowMax = TAPSTARK_BITREV_NARROW_MAX;  // columns at most of the narrow form
constexpr int kNarrowThreads = 256;

__device__ __forceinline__ unsigned rev_bits(unsigned x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

__global__ void __launch_bounds__(kNarrowThreads)
    bitrev_cols_narrow_kernel(const uint32_t* __restrict__ src, int width, int log_m, uint32_t* __restrict__ dst) {
  __shared__ uint32_t tile[kTile * (kTile * kNarrowMax + 1)];  // [a][c * width + j], each a padded by a word
  const long long m = 1ll << log_m;
  const unsigned mid = blockIdx.x;
  const int row_words = kTile * width, pitch = row_words + 1, n = kTile * row_words;
  for (int t = threadIdx.x; t < n; t += kNarrowThreads) {
    const int a = t / row_words, rest = t - a * row_words;
    const long long r0 = (static_cast<long long>(a) << (log_m - 5)) + (static_cast<long long>(mid) << 5);
    tile[a * pitch + rest] = src[r0 * width + rest];
  }
  __syncthreads();
  const long long mid_rev = static_cast<long long>(rev_bits(mid, log_m - 10)) << 5;
  for (int t = threadIdx.x; t < n; t += kNarrowThreads) {
    const int a = t & (kTile - 1), c = (t >> 5) & (kTile - 1), j = t >> 10;
    const long long i = (static_cast<long long>(rev_bits(c, 5)) << (log_m - 5)) | mid_rev | rev_bits(a, 5);
    dst[static_cast<long long>(j) * m + i] = tile[a * pitch + c * width + j];
  }
}

}  // namespace

extern "C" {

// src: (at least 2^log_m, width) row-major words; dst: (width, 2^log_m), distinct.
int tapstark_bitrev_cols(const uint32_t* src, int width, int log_m, uint32_t* dst, void* stream) {
  if (width <= 0 || log_m < 0 || log_m > 31 || (width + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= kNarrowMax && log_m >= 10) {
    bitrev_cols_narrow_kernel<<<1u << (log_m - 10), kNarrowThreads, 0, s>>>(src, width, log_m, dst);
  } else {
    const dim3 grid(static_cast<unsigned>(((1ll << log_m) + kTile - 1) / kTile), (width + kTile - 1) / kTile);
    bitrev_cols_kernel<<<grid, dim3(kTile, kTileRows), 0, s>>>(src, width, log_m, dst);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
