// DIF column transforms over BabyBear on Hopper (sm_90a), the mirror of
// dit_cols.cuh, shared by dif_cols (the counterpart of K4) and
// lde_inverse (K1's): both run an inverse transform to coefficients in
// bit-reversed order as the four-step pair below, through the entry
// points of ntt_cols.cu.
//
// The pair. An n = R*C point DIF with natural input i = i1*C + i2 (i1 the
// high digit) and output in bitrev_n order, position p = p1*C + p2
// holding coefficient brv_n(p) = brv_C(p2)*R + brv_R(p1), splits as
//   column form, over the R rows:  A[p1, i2] = sum_i1 x[i1*C + i2] *
//       w_R^(i1*brv_R(p1))                             (an R-point DIF),
//   last member, one block per p1:  Y[p1*C + p2] = sum_i2 A[p1, i2] *
//       w_n^(brv_R(p1)*i2) * w_C^(i2*brv_C(p2))       (a C-point DIF),
// each down axis 0 of a matrix whose lanes are independent columns (w the
// inverse root here: the last member runs inverse transforms only). The
// column form's lanes are (i2, c), the natural (n, w) evaluations viewed as
// (R, C*w); its output row p1 is the last member's input, one contiguous
// run of C*w words a block. The last member multiplies by the outer
// twiddle (and 1/n when asked) on load and stores position p1*C + p2 of
// column c at out[(p1*C + p2) * out_row + c * out_col]: one kernel writes
// the blocks route's (n, w) and lde_inverse's (w, n), so no pass between
// or after the two launches touches the data.
//
// What bounds it: what bounds the DIT. A DIF butterfly is the DIT's 9
// integer instructions in the other order (both inputs reduced to [0, p),
// their sum, their difference plus p, a Shoup product of the difference)
// on 8 bytes per stage per element; device memory is read once and written
// once. At the 2^22-row prove's shapes both roofs are under a tenth of a
// millisecond, so the time goes to what surrounds the butterflies.
//
// What the design does about it: dit_cols.cuh's, stage for stage in the
// other order.
// - The same tile and launch bounds: all R rows of 2^log_l lanes in a 64
//   KiB tile, two 512-thread blocks an SM at 64 registers a thread.
// - Radix-16 register passes, the widest first, stages from a span of R
//   down to 2: R = 2^11 takes 4, 4 and 3 stages, 2 exchanges through
//   shared memory and 2 barriers, not 11. The first pass loads from device
//   memory and the last stores to it directly.
// - Stage s of a DIF multiplies by the same w_{2^s}^j as stage s of a
//   DIT, so dit_tables.dit_stage_pairs of the wanted direction serves both
//   designs: staged in shared memory once per block as (w, ws) pairs.
// - The last pass has a warp's rows 2^kl apart (kl its stages), every
//   other pass consecutive rows: rows are XOR-swizzled by their bits above
//   that span (or above the rows a warp covers, whichever is higher), so
//   the last pass and the consecutive passes are free of bank conflicts.
// - Values ride lazily in [0, 2p) and are canonical on store, so every
//   stored word equals the TPU's whatever the order of the butterflies.
// - The last member's outer twiddles w_n^(brv_R(p1) * i2), rows i2 = base
//   + m * step, are t0 * d^m (t0 times the block-wide 1/n or 1): two
//   Montgomery products of two sqrt(n)-entry tables each for t0 and d,
//   then one product a row, as the DIT's first member; not a gather of
//   the (R, C) table.
// - A column form whose grid of full tiles would hold fewer than two
//   blocks an SM takes narrower tiles, down to 8 lanes (32-byte runs),
//   until it does: lde_inverse's column form at 2^20 x 2 (8 MiB, 2^9 rows)
//   would be 128 tiles of 64 KiB against 132 SMs; with 8 lanes it is 512
//   tiles of 16 KiB.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "dit_cols.cuh"

namespace {

constexpr int kDifMinLogLanes = 3;  // the narrowest tile that fills the card: 8 lanes

// x, opaque to the compiler: offsets formed from it inside a loop stay
// there instead of being hoisted out and held in registers (with them the
// DIF kernels spill at 64 registers; the DIT kernels do not need it).
__device__ __forceinline__ uint32_t dif_opaque(uint32_t x) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
#endif
  return x;
}

// K stages s+K-1 down to s (1-based) on v[m] = row base + m * 2^(s-1),
// low = base mod 2^(s-1); tw as dit_radix's.
template <int K>
__device__ __forceinline__ void dif_radix(uint32_t (&v)[1 << K], const uint2* tw, int s,
                                          uint32_t low) {
#pragma unroll
  for (int t = K - 1; t >= 0; --t) {
    const uint2* tws = tw + ((1u << (s + t - 1)) - 1u) + low;
#pragma unroll
    for (int m = 0; m < (1 << K); ++m) {
      if (m & (1 << t)) continue;
      const uint2 w = tws[(m & ((1 << t) - 1)) << (s - 1)];
      const uint32_t lo = reduce2p(v[m]);
      const uint32_t hi = reduce2p(v[m | (1 << t)]);
      v[m] = lo + hi;
      v[m | (1 << t)] = shoup_mul(w.x, w.y, lo - hi + kP);
    }
  }
}

// One pass of K stages down to stage s over the tile's groups of 2^K rows,
// items and groups as dit_pass's.
template <int K, class Load, class Store>
__device__ __forceinline__ void dif_pass(int s, int log_r, int log_l, const uint2* tw,
                                         const Load& load, const Store& store) {
  const uint32_t items = 1u << (log_r - K + log_l);
  const uint32_t lmask = (1u << log_l) - 1u;
  const uint32_t umask = (1u << (s - 1)) - 1u;
  for (uint32_t i = threadIdx.x; i < items; i += blockDim.x) {
    const uint32_t lane = i & lmask;
    const uint32_t g = i >> log_l;
    const uint32_t low = g & umask;
    const uint32_t base = ((g >> (s - 1)) << (s - 1 + K)) | low;
    const int so = static_cast<int>(dif_opaque(s));
    uint32_t v[1 << K];
    load(base, 1u << (so - 1), lane, v);
    dif_radix<K>(v, tw, so, dif_opaque(low));
    store(base, 1u << (so - 1), lane, v);
  }
}

template <class Load, class Store>
__device__ __forceinline__ void dif_pass_any(int k, int s, int log_r, int log_l, const uint2* tw,
                                             const Load& load, const Store& store) {
  switch (k) {
    case 1: dif_pass<1>(s, log_r, log_l, tw, load, store); break;
    case 2: dif_pass<2>(s, log_r, log_l, tw, load, store); break;
    case 3: dif_pass<3>(s, log_r, log_l, tw, load, store); break;
    default: dif_pass<4>(s, log_r, log_l, tw, load, store); break;
  }
}

// The whole R-point DIF of a block's tile: stage the twiddles, then the
// passes, widest first from stage log_r down; the first loads through
// load_g, the last stores through store_g (values in [0, 2p)), the others
// go through the swizzled tile in shared memory.
template <class LoadG, class StoreG>
__device__ __forceinline__ void dif_tile(int log_r, int log_l, const uint2* __restrict__ tw_g,
                                         const LoadG& load_g, const StoreG& store_g) {
  extern __shared__ uint32_t dif_sm[];
  uint2* tw = reinterpret_cast<uint2*>(dif_sm + (1u << (log_r + log_l)));
  for (uint32_t i = threadIdx.x; i + 1u < (1u << log_r); i += blockDim.x) tw[i] = tw_g[i];
  __syncthreads();

  const int np = dit_passes(log_r);
  // a warp's rows: 2^kl apart in the last pass, runs of 2^lw consecutive
  // rows in the others
  const int kl = dit_pass_stages(log_r, np - 1);
  const int lw = 5 - log_l;
  const int sh = kl > lw ? kl : lw;
  const uint32_t xmask = (1u << (kl < lw ? kl : lw)) - 1u;
  auto slot = [&](uint32_t row, uint32_t lane) {
    return ((row ^ ((row >> sh) & xmask)) << log_l) | lane;
  };
  auto load_s = [&](uint32_t base, uint32_t step, uint32_t lane, auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
#pragma unroll
    for (int m = 0; m < n; ++m) v[m] = dif_sm[slot(base + m * step, lane)];
  };
  auto store_s = [&](uint32_t base, uint32_t step, uint32_t lane, const auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
#pragma unroll
    for (int m = 0; m < n; ++m) dif_sm[slot(base + m * step, lane)] = v[m];
  };

  int top = log_r;
  for (int p = 0; p < np; ++p) {
    const int k = dit_pass_stages(log_r, p);
    const int s = top - k + 1;
    if (np == 1) {
      dif_pass_any(k, s, log_r, log_l, tw, load_g, store_g);
    } else if (p == 0) {
      dif_pass_any(k, s, log_r, log_l, tw, load_g, store_s);
    } else if (p == np - 1) {
      dif_pass_any(k, s, log_r, log_l, tw, load_s, store_g);
    } else {
      dif_pass_any(k, s, log_r, log_l, tw, load_s, store_s);
    }
    if (p + 1 < np) __syncthreads();
    top -= k;
  }
}

// The column form (and any plain column DIF): (R, b) row-major in and
// out, rows natural in, bit-reversed out, no 1/n. Block x takes lanes
// [x * 2^log_l, (x + 1) * 2^log_l) and masks the ragged last block. The
// lane's column and pointers are formed where they are used, and offsets
// within the matrix are 32-bit (R * b < 2^32), which keeps the kernel
// within 64 registers without spilling.
__global__ void __launch_bounds__(kDitThreads, 2)
    dif_cols_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                    const uint2* __restrict__ tw, int log_r, long long b, int log_l) {
  auto load = [&](uint32_t base, uint32_t step, uint32_t lane, auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    const long long col = (static_cast<long long>(blockIdx.x) << log_l) + lane;
    const uint32_t* x = src + col;
#pragma unroll
    for (int m = 0; m < n; ++m) v[m] = col < b ? x[(base + m * step) * static_cast<uint32_t>(b)] : 0u;
  };
  auto store = [&](uint32_t base, uint32_t step, uint32_t lane, const auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    const long long col = (static_cast<long long>(blockIdx.x) << log_l) + lane;
    if (col >= b) return;
    uint32_t* y = dst + col;
#pragma unroll
    for (int m = 0; m < n; ++m) y[(base + m * step) * static_cast<uint32_t>(b)] = reduce2p(v[m]);
  };
  dif_tile(log_r, log_l, tw, load, store);
}

struct DifLastArgs {
  const uint32_t* a;        // (R, C * width): A[p1, (i2, c)], the column form's output
  uint32_t* out;            // position p1*C + p2 of column c at out[(p1*C + p2) * out_row + c * out_col]
  long long out_row, out_col;
  const uint2* tw;          // the C-point DIF's stage pairs (inverse)
  const uint32_t* hi;       // Montgomery w_n^(-i * 2^h), i < n / 2^h
  const uint32_t* lo;       // Montgomery w_n^(-j), j < 2^h
  uint32_t c0;              // Montgomery 1/n, or 1
  int log_r, log_c, h, width, log_l;
};

// The last member: block (p1, y) takes row p1 of A (C rows i2 of `width`
// lanes) and lanes [y * 2^log_l, ...) of it. Pointers and exponents are
// formed from the parameters where they are used, so that only the lane
// stays live beside the radix pass's values.
__global__ void __launch_bounds__(kDitThreads, 2) dif_last_kernel(__grid_constant__ const DifLastArgs a) {
  const int lane = static_cast<int>((blockIdx.y << a.log_l) + (threadIdx.x & ((1u << a.log_l) - 1u)));
  const bool live = lane < a.width;  // a dead lane loads lane 0's inputs and stores nothing
  const int c = live ? lane : 0;
  auto twiddle = [&](uint32_t k) {  // w_n^(-k * brv_R(p1))
    const uint32_t beta = a.log_r ? __brev(blockIdx.x) >> (32 - a.log_r) : 0u;
    const uint32_t e = (k * beta) & ((1u << (a.log_r + a.log_c)) - 1u);
    return mont_mul(a.hi[e >> a.h], a.lo[e & ((1u << a.h) - 1u)]);
  };
  // row i2 = base + m * step is loaded times t0 * d^m, t0 and d the
  // twiddles of base and step (t0 times c0): four table loads a group
  auto load = [&](uint32_t base, uint32_t step, uint32_t, auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    const uint32_t* x = a.a + (static_cast<long long>(blockIdx.x) << a.log_c) * a.width + c;
    const uint32_t d = twiddle(step);
    uint32_t t = mont_mul(twiddle(base), a.c0);
#pragma unroll
    for (int m = 0; m < n; ++m) {
      v[m] = mont_mul(x[(base + m * step) * static_cast<uint32_t>(a.width)], t);
      if (m + 1 < n) t = mont_mul(t, d);
    }
  };
  auto store = [&](uint32_t base, uint32_t step, uint32_t, const auto& v) {
    constexpr int n = sizeof(v) / sizeof(v[0]);
    if (!live) return;
    uint32_t* out = a.out + (static_cast<long long>(blockIdx.x) << a.log_c) * a.out_row + c * a.out_col;
#pragma unroll
    for (int m = 0; m < n; ++m) out[(base + m * step) * static_cast<uint32_t>(a.out_row)] = reduce2p(v[m]);
  };
  dif_tile(a.log_c, a.log_l, a.tw, load, store);
}

// The last member's arguments as the entry points take them (log_l is
// set by dif_last_shape).
inline DifLastArgs dif_last_args(const uint32_t* a, uint32_t* out, long long out_row, long long out_col,
                                 const uint32_t* tw, const uint32_t* hi, const uint32_t* lo, uint32_t c0,
                                 int log_r, int log_c, int h, int width) {
  return DifLastArgs{a,  out, out_row, out_col, reinterpret_cast<const uint2*>(tw), hi, lo, c0,
                     log_r, log_c, h, width, 0};
}

// The launch shape of a last member (grid 2^log_r x d.lane_blocks), with
// a.log_l set; false if no launch takes these arguments.
inline bool dif_last_shape(DifLastArgs& a, DitShape& d) {
  if (a.log_r < 0 || a.log_r > kDitMaxLogR || a.log_c < 1 || a.log_c > kDitMaxLogR || a.width < 1 ||
      a.out_row < 1 || a.out_col < 1) {
    return false;
  }
  d = dit_shape(a.log_c, a.width);
  if (d.lane_blocks > 65535 || (static_cast<long long>(a.width) << a.log_c) >= (1ll << 32) ||
      (a.out_row << a.log_c) >= (1ll << 32)) {
    return false;
  }
  a.log_l = d.log_l;
  return true;
}

// The launch shape of a column DIF over (2^log_r, b < 2^32 / 2^log_r):
// full tiles, or narrower ones while the grid holds fewer than min_blocks
// blocks; false if no launch takes it.
inline bool dif_cols_shape(int log_r, long long b, long long min_blocks, DitShape& d) {
  if (log_r < 1 || log_r > kDitMaxLogR || b < 1) return false;
  if ((b << log_r) >= (1ll << 32)) return false;
  d = dit_shape(log_r, b);
  while (d.log_l > kDifMinLogLanes && d.lane_blocks < min_blocks) d = dit_shape(log_r, b, d.log_l - 1);
  return true;
}

#ifdef __CUDACC__

// min_blocks: two resident blocks on each SM of the current device.
cudaError_t launch_dif_cols(const uint32_t* src, uint32_t* dst, const uint2* tw, int log_r,
                            long long b, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  DitShape d;
  if (!dif_cols_shape(log_r, b, 2ll * sms, d)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(dif_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(d.smem));
  if (e != cudaSuccess) return e;
  dif_cols_kernel<<<static_cast<unsigned>(d.lane_blocks), d.threads, d.smem, stream>>>(
      src, dst, tw, log_r, b, d.log_l);
  return cudaGetLastError();
}

cudaError_t launch_dif_last(DifLastArgs a, cudaStream_t stream) {
  DitShape d;
  if (!dif_last_shape(a, d)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dif_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(d.smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(1u << a.log_r, static_cast<unsigned>(d.lane_blocks));
  dif_last_kernel<<<grid, d.threads, d.smem, stream>>>(a);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace
