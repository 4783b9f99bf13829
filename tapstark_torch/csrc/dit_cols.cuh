// DIT column transforms over BabyBear on Hopper (sm_90a), shared by
// dit_cols (the counterpart of K3) and lde_forward (K2's): both run a
// forward LDE as the four-step pair below, through the entry points of
// ntt_cols.cu. Its twin, dif_cols.cuh, runs the inverse half (K4's and
// K1's counterparts) on the same design, stage for stage in the other
// order.
//
// The pair. An n = R*C point DIT with bit-reversed input p = p2*R + p1
// (p2 the high digit) and natural output k = k2*R + k1 splits as
//   first member, one block per p2:  B[p2, k1] = w_n^(k1*brv_C(p2)) *
//       sum_p1 x[p2*R + p1] * w_R^(brv_R(p1)*k1)   (an R-point DIT),
//   second member, over the C rows:  X[k2*R + k1] = sum_p2 B[p2, k1] *
//       w_C^(brv_C(p2)*k2)                          (a C-point DIT),
// each down axis 0 of a matrix whose lanes are independent columns. For a
// coset LDE the lanes of B are (k1, rb, c): blow blocks rb of w columns c,
// block rb's input scaled by the powers of shift * w_N^rb (N = blow*n), and
// the second member's output (C, R*blow*w) is then already the natural
// (N, w) coset evaluations. The first member scales on load and multiplies
// by the outer twiddle on store, so no pass between the two launches
// touches the data, and each block reads one contiguous run of R rows and
// writes one contiguous run of R*blow*w words.
//
// What bounds it. A butterfly is 9 integer instructions (a Shoup product:
// umulhi and two IMADs; two lazy reductions; an add and a sub) on 8 bytes
// per stage per element;
// device memory is read once and written once. At the 2^22-row prove's
// shapes (R = C = 2^11, 8 or 16 lanes per row of the first member, 2^14 or
// 2^15 of the second) the integer-instruction roof and the byte roof are both
// under a tenth of a millisecond, so the time goes to what surrounds the
// butterflies: address arithmetic, shared-memory exchanges, barriers,
// twiddle loads and the latency between them.
//
// What the design does about it.
// - A block holds all R rows of 2^log_l lanes in a 64 KiB tile, so two
//   blocks (512 threads each, at most 64 registers a thread) share an SM
//   and one block's loads overlap the other's arithmetic.
// - A thread runs up to 4 consecutive stages (radix 16) on 16 values of
//   one lane in registers: R = 2^11 takes passes of 4, 4 and 3 stages, so
//   2 exchanges through shared memory and 2 barriers, not 11. The first
//   pass loads from device memory and the last stores to it directly.
// - The stage twiddles and their Shoup companions are staged in shared
//   memory once per block, one (w, ws) pair per 8-byte load, stage s at
//   offset 2^(s-1) - 1.
// - Rows are XOR-swizzled by their bits above the first pass's span, so
//   the first pass's stores (rows 16 apart across a warp) and every later
//   pass (consecutive rows across a warp) are free of bank conflicts.
// - Values ride lazily in [0, 2p) between stages and are canonical on
//   store, so every stored word equals the TPU's whatever the order of the
//   butterflies.
// - The first member's block scale factors as b^brv_n(p) = s1[rb, p1] *
//   s2[rb, p2]: one Shoup product by the (blow, R) table on load, and the
//   block's s2 (which may carry 1/n) folded into the outer twiddle on
//   store, not a read of the (blow, n) table. A group's outer twiddles
//   w_n^(k1 * brv_C(p2)), rows k1 = base + m * step, are t0 * d^m: two
//   Montgomery products of two sqrt(n)-entry tables each for t0 and d, then
//   one product a row, not a gather of the (R, C) table.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int kDitMaxLogR = 14;     // the four-step split of 2^27 is 14 + 13
constexpr int kDitTileLog = 14;     // a block's tile: 2^14 words = 64 KiB
constexpr int kDitMaxLogLanes = 5;  // at most 32 lanes a block
constexpr int kDitMaxRadix = 4;     // stages a thread runs in registers per pass
constexpr int kDitThreads = 512;

__host__ __device__ inline int dit_passes(int log_r) {
  return (log_r + kDitMaxRadix - 1) / kDitMaxRadix;
}

// Stages of pass k when log_r stages are split as evenly as possible,
// widest first.
__host__ __device__ inline int dit_pass_stages(int log_r, int k) {
  const int np = dit_passes(log_r);
  return log_r / np + (k < log_r % np ? 1 : 0);
}

// The launch shape of a DIT (or DIF) over 2^log_r rows of `lanes` lanes.
struct DitShape {
  int log_l;     // lanes a block: 2^log_l
  int threads;
  size_t smem;   // the tile, then R - 1 twiddle pairs
  long long lane_blocks;
};

// At most 2^max_log_l lanes a block (dif_cols.cuh narrows the tile to
// fill the card).
inline DitShape dit_shape(int log_r, long long lanes, int max_log_l = kDitMaxLogLanes) {
  DitShape d{};
  int cap = kDitTileLog - log_r;
  if (cap > max_log_l) cap = max_log_l;
  while (d.log_l < cap && (1ll << d.log_l) < lanes) ++d.log_l;
  int t = 1 << (log_r + d.log_l - dit_pass_stages(log_r, 0));  // items of the widest pass
  if (t < 32) t = 32;
  if (t > kDitThreads) t = kDitThreads;
  d.threads = t;
  d.smem = (sizeof(uint32_t) << (log_r + d.log_l)) + sizeof(uint2) * ((1u << log_r) - 1u);
  d.lane_blocks = (lanes + (1ll << d.log_l) - 1) >> d.log_l;
  return d;
}

// K stages s .. s+K-1 (1-based) on v[m] = row base + m * 2^(s-1), where
// low = base mod 2^(s-1). tw: stage s' at offset 2^(s'-1) - 1, entry j the
// pair (w_{2^s'}^j canonical, its Shoup companion).
template <int K>
__device__ __forceinline__ void dit_radix(uint32_t (&v)[1 << K], const uint2* tw, int s,
                                          uint32_t low) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const uint2* tws = tw + ((1u << (s + t - 1)) - 1u) + low;
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & (1 << t)) continue;
      const uint2 w = tws[(m & ((1 << t) - 1)) << (s - 1)];
      const uint32_t x = reduce2p(shoup_mul(w.x, w.y, v[m | (1 << t)]));
      const uint32_t lo = reduce2p(v[m]);
      v[m] = lo + x;
      v[m | (1 << t)] = lo - x + kP;
    }
  }
}

// One pass of K stages from stage s over the tile's groups of 2^K rows:
// item i is lane i mod 2^log_l of group i >> log_l. load(base, step, lane,
// v) fills v[m] with row base + m * step; store(base, step, lane, v)
// writes it back.
template <int K, class Load, class Store>
__device__ __forceinline__ void dit_pass(int s, int log_r, int log_l, const uint2* tw,
                                         const Load& load, const Store& store) {
  const uint32_t items = 1u << (log_r - K + log_l);
  const uint32_t lmask = (1u << log_l) - 1u;
  const uint32_t umask = (1u << (s - 1)) - 1u;
  for (uint32_t i = threadIdx.x; i < items; i += blockDim.x) {
    const uint32_t lane = i & lmask;
    const uint32_t g = i >> log_l;
    const uint32_t low = g & umask;
    const uint32_t base = ((g >> (s - 1)) << (s - 1 + K)) | low;
    uint32_t v[1 << K];
    load(base, 1u << (s - 1), lane, v);
    dit_radix<K>(v, tw, s, low);
    store(base, 1u << (s - 1), lane, v);
  }
}

template <class Load, class Store>
__device__ __forceinline__ void dit_pass_any(int k, int s, int log_r, int log_l, const uint2* tw,
                                             const Load& load, const Store& store) {
  switch (k) {
    case 1: dit_pass<1>(s, log_r, log_l, tw, load, store); break;
    case 2: dit_pass<2>(s, log_r, log_l, tw, load, store); break;
    case 3: dit_pass<3>(s, log_r, log_l, tw, load, store); break;
    default: dit_pass<4>(s, log_r, log_l, tw, load, store); break;
  }
}

// The whole R-point DIT of a block's tile: stage the twiddles, then the
// passes; the first loads through load_g, the last stores through store_g
// (values in [0, 2p)), the others go through the swizzled tile in shared
// memory.
template <class LoadG, class StoreG>
__device__ __forceinline__ void dit_tile(int log_r, int log_l, const uint2* __restrict__ tw_g,
                                         const LoadG& load_g, const StoreG& store_g) {
  extern __shared__ uint32_t dit_sm[];
  uint2* tw = reinterpret_cast<uint2*>(dit_sm + (1u << (log_r + log_l)));
  for (uint32_t i = threadIdx.x; i + 1u < (1u << log_r); i += blockDim.x) tw[i] = tw_g[i];
  __syncthreads();

  const int np = dit_passes(log_r);
  const int k0 = dit_pass_stages(log_r, 0);
  // a warp's rows: 16 apart in the first pass, consecutive in the others
  uint32_t rows_per_warp = 32u >> log_l;
  if (rows_per_warp > (1u << k0)) rows_per_warp = 1u << k0;
  const uint32_t xmask = rows_per_warp - 1u;
  auto slot = [&](uint32_t row, uint32_t lane) {
    return ((row ^ ((row >> k0) & xmask)) << log_l) | lane;
  };
  auto load_s = [&](uint32_t base, uint32_t step, uint32_t lane, auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
#pragma unroll
    for (int m = 0; m < n; ++m) v[m] = dit_sm[slot(base + m * step, lane)];
  };
  auto store_s = [&](uint32_t base, uint32_t step, uint32_t lane, const auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
#pragma unroll
    for (int m = 0; m < n; ++m) dit_sm[slot(base + m * step, lane)] = v[m];
  };

  int s = 1;
  for (int p = 0; p < np; ++p) {
    const int k = dit_pass_stages(log_r, p);
    if (np == 1) {
      dit_pass_any(k, s, log_r, log_l, tw, load_g, store_g);
    } else if (p == 0) {
      dit_pass_any(k, s, log_r, log_l, tw, load_g, store_s);
    } else if (p == np - 1) {
      dit_pass_any(k, s, log_r, log_l, tw, load_s, store_g);
    } else {
      dit_pass_any(k, s, log_r, log_l, tw, load_s, store_s);
    }
    if (p + 1 < np) __syncthreads();
    s += k;
  }
}

// The second member (and any plain column DIT): (R, b) row-major in and
// out, rows bit-reversed in, natural out. Block x takes lanes
// [x * 2^log_l, (x + 1) * 2^log_l) and masks the ragged last block.
__global__ void __launch_bounds__(kDitThreads, 2)
    dit_cols_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                    const uint2* __restrict__ tw, int log_r, long long b, int log_l) {
  const long long col =
      (static_cast<long long>(blockIdx.x) << log_l) + (threadIdx.x & ((1u << log_l) - 1u));
  const bool live = col < b;
  auto load = [&](uint32_t base, uint32_t step, uint32_t, auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
#pragma unroll
    for (int m = 0; m < n; ++m) v[m] = live ? src[(base + m * step) * b + col] : 0u;
  };
  auto store = [&](uint32_t base, uint32_t step, uint32_t, const auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    if (!live) return;
#pragma unroll
    for (int m = 0; m < n; ++m) dst[(base + m * step) * b + col] = reduce2p(v[m]);
  };
  dit_tile(log_r, log_l, tw, load, store);
}

struct DitFirstArgs {
  const uint32_t* x;      // coefficient j of column c at x[j * x_row + c * x_col], j in bitrev_n order
  long long x_row, x_col;
  uint32_t* out;          // (C, R * blow * width): B[p2, (k1, rb, c)]
  const uint2* tw;        // the R-point DIT's stage pairs
  const uint2* s1;        // (blow, R): base_rb^(C * brv_R(p1)), canonical + companion
  const uint32_t* s2;     // (blow, C): Montgomery base_rb^(brv_C(p2)) * c0
  const uint32_t* hi;     // Montgomery w_n^(i * 2^h), i < n / 2^h
  const uint32_t* lo;     // Montgomery w_n^j, j < 2^h
  int log_r, log_c, h, width, lanes, log_l;
};

// The first member: block (p2, y) takes the R rows p2*R + p1 of the
// coefficients and lanes [y * 2^log_l, ...) of (rb, c). Pointers and
// exponents are formed from the parameters where they are used, so that
// only the lane's (rb, c) stays live beside the radix pass's values.
__global__ void __launch_bounds__(kDitThreads, 2) dit_first_kernel(__grid_constant__ const DitFirstArgs a) {
  const int lane = static_cast<int>((blockIdx.y << a.log_l) + (threadIdx.x & ((1u << a.log_l) - 1u)));
  const bool live = lane < a.lanes;  // a dead lane loads lane 0's inputs and stores nothing
  const int rb = live ? lane / a.width : 0;
  const int c = live ? lane - rb * a.width : 0;
  auto load = [&](uint32_t base, uint32_t step, uint32_t, auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    const uint2* s1 = a.s1 + (static_cast<size_t>(rb) << a.log_r);
    const uint32_t* x = a.x + (static_cast<long long>(blockIdx.x) << a.log_r) * a.x_row + c * a.x_col;
#pragma unroll
    for (int m = 0; m < n; ++m) {
      const uint32_t p1 = base + m * step;
      const uint2 f = s1[p1];
      v[m] = shoup_mul(f.x, f.y, x[p1 * static_cast<uint32_t>(a.x_row)]);
    }
  };
  // row k1 = base + m * step leaves times s2 (the block's part of the
  // scale: the transform is linear) and its outer twiddle, t0 * d^m with
  // t0, d the twiddles of base and step: five table loads a group, not 2n
  auto twiddle = [&](uint32_t k) {
    const uint32_t beta = a.log_c ? __brev(blockIdx.x) >> (32 - a.log_c) : 0u;
    const uint32_t e = (k * beta) & ((1u << (a.log_r + a.log_c)) - 1u);
    return mont_mul(a.hi[e >> a.h], a.lo[e & ((1u << a.h) - 1u)]);
  };
  auto store = [&](uint32_t base, uint32_t step, uint32_t, const auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    if (!live) return;
    const uint32_t d = twiddle(step);
    uint32_t t = mont_mul(twiddle(base), a.s2[(static_cast<uint32_t>(rb) << a.log_c) + blockIdx.x]);
    uint32_t* out = a.out + (static_cast<long long>(blockIdx.x) << a.log_r) * a.lanes + lane;
#pragma unroll
    for (int m = 0; m < n; ++m) {
      out[(base + m * step) * static_cast<uint32_t>(a.lanes)] = mont_mul(v[m], t);
      if (m + 1 < n) t = mont_mul(t, d);
    }
  };
  dit_tile(a.log_r, a.log_l, a.tw, load, store);
}

// The first member's arguments as the entry points take them (lanes =
// width * blow; log_l is set by dit_first_shape).
inline DitFirstArgs dit_first_args(const uint32_t* x, long long x_row, long long x_col, uint32_t* out,
                                   const uint32_t* tw, const uint32_t* s1, const uint32_t* s2,
                                   const uint32_t* hi, const uint32_t* lo, int log_r, int log_c, int h,
                                   int log_blowup, int width) {
  return DitFirstArgs{x, x_row, x_col, out, reinterpret_cast<const uint2*>(tw),
                      reinterpret_cast<const uint2*>(s1), s2, hi, lo, log_r, log_c, h, width,
                      width << log_blowup, 0};
}

// The launch shape of a first member (grid 2^log_c x d.lane_blocks), with
// a.log_l set; false if no launch takes these arguments.
inline bool dit_first_shape(DitFirstArgs& a, DitShape& d) {
  if (a.log_r < 1 || a.log_r > kDitMaxLogR || a.log_c < 0 || a.log_c > kDitMaxLogR ||
      a.width < 1 || a.lanes < 1) {
    return false;
  }
  d = dit_shape(a.log_r, a.lanes);
  if (d.lane_blocks > 65535 || (static_cast<long long>(a.lanes) << a.log_r) >= (1ll << 32) ||
      (a.x_row << a.log_r) >= (1ll << 32)) {
    return false;
  }
  a.log_l = d.log_l;
  return true;
}

// The launch shape of a column DIT over (2^log_r, b); false if no launch
// takes it.
inline bool dit_cols_shape(int log_r, long long b, DitShape& d) {
  if (log_r < 1 || log_r > kDitMaxLogR || b < 1) return false;
  d = dit_shape(log_r, b);
  return d.lane_blocks <= 0x7fffffffll;
}

#ifdef __CUDACC__

cudaError_t launch_dit_cols(const uint32_t* src, uint32_t* dst, const uint2* tw, int log_r,
                            long long b, cudaStream_t stream) {
  DitShape d;
  if (!dit_cols_shape(log_r, b, d)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dit_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(d.smem));
  if (e != cudaSuccess) return e;
  dit_cols_kernel<<<static_cast<unsigned>(d.lane_blocks), d.threads, d.smem, stream>>>(
      src, dst, tw, log_r, b, d.log_l);
  return cudaGetLastError();
}

cudaError_t launch_dit_first(DitFirstArgs a, cudaStream_t stream) {
  DitShape d;
  if (!dit_first_shape(a, d)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dit_first_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(d.smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(1u << a.log_c, static_cast<unsigned>(d.lane_blocks));
  dit_first_kernel<<<grid, d.threads, d.smem, stream>>>(a);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace
