// The limb-matmul NTT's member transform on Hopper (sm_90a): an exact
// modular DFT-matrix product on the u8 tensor cores, through wgmma, fed by
// TMA (tapstark_torch/poly/matmul_ntt.py `mod_matmul`).
//
// Replaces the TPU kernel of tapstark/poly/matmul_ntt.py:
//   mod_matmul <- _fused_kernel / _fused_kernel_tw (K7, via
//                 mod_matmul_fused): out = W (R x R) @ x (R x B) mod p for
//                 canonical x, R <= 128, optionally times an (R, B)
//                 Montgomery twiddle in the epilogue, word for word.
// It has two forms: the natural (R, B) output, and the output written as
// the next level of the limb-matmul recursion wants it (width w > 0:
// B = C * w, element (k, i2 * w + wi) to (i2, k * w + wi) of a (C, R * w)
// matrix), so a level of `ntt_matmul` is one launch and no transpose.
//
// Arithmetic and layouts: matmul_ntt.cuh (four byte limbs, 16 u8 dots in
// 7 s32 buckets, one Montgomery reduction of a 64-bit sum per output; the
// product computed as out^T = x^T W^T, W the K-major B operand as stored,
// x^T the A operand built in registers).
//
// What bounds it. x, the twiddles and the output move 12 bytes per output
// at R = 128; at 3.35 TB/s that takes longer than the 16 u8 dots at the
// dense int8 rate (0.58 of it) or the ~23 integer instructions of the
// epilogue per output (0.19). The kernel meets the byte bound only if x,
// the twiddles and the stores keep streaming while the tensor cores and
// the epilogue run.
//
// What the design does about it. A persistent grid of one block per SM
// (at most one per 64-column tile) walks the tiles. The block loads W's 4
// limb planes once (64 KiB at R = 128), by one bulk copy from a host table
// already in wgmma's swizzled layout. Two consumer warpgroups take
// alternate tiles ("ping-pong"), so that one's fragment build, folds and
// stores overlap the other's wgmmas; a producer warpgroup (its registers
// handed to the consumers by setmaxnreg) has one thread for each of them,
// which keeps that warpgroup's next tile of x and of the twiddles in
// flight by TMA (R x 64 words each, two 32-column boxes, 128-byte swizzle)
// into its two stages of a ring on mbarriers: the x stage comes free as
// soon as the fragments are built, the twiddle stage after the epilogue.
// For its tile a thread reads its words of x once (8-byte loads),
// byte-permutes them into the A fragments of all K steps and limbs (64
// registers at R = 128); then for each half of the R outputs (N = R / 2)
// it runs the 7 buckets in turn, each the bucket's limb pairs x K steps of
// m64nNk32 wgmma into one s32 accumulator, then one wide multiply-add per
// output into a 64-bit sum. The epilogue reduces each sum once, multiplies
// by the twiddle read from its stage, and stores from registers into
// either form, two adjacent columns as one 8-byte store where they are
// adjacent in the output. R < 16 is padded to 16 rows and K to 32, exact
// with zeros in W. A wait on an mbarrier that never completes traps
// rather than hanging the card.
// Measured (PERF.md): half of the byte bound at R = 128; the epilogue's
// integer work, on two warps a scheduler, is the largest part left. A
// second accumulator, folding one bucket while the next one's wgmmas run,
// was tried and gained nothing measurable. Not yet done: fragment loads
// free of the 2-way bank conflict the 128-byte swizzle leaves.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its encoder's types (the encoder is found at run time)
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "matmul_ntt.cuh"

namespace {

constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = (kConsumerWarps + 4) * 32;  // and a producer warpgroup
// Registers a thread after the producer warpgroup hands its share to the
// consumers: 2 * 128 * 232 + 128 * 40 <= 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int RP>
struct Shape {
  static constexpr int kSteps = k_steps(RP);
  static constexpr int kNwg = RP / 2;  // N of one wgmma: half the output rows
  static constexpr int kAcc = kNwg / 2;  // accumulator registers a thread
  static constexpr int kPlaneBytes = RP * 128;
  static constexpr int kWBytes = kLimbs * kPlaneBytes;
  static constexpr int kBoxBytes = RP * kBoxCols * 4;
  static constexpr int kTileBytes = 2 * kBoxBytes;  // a tile of x or of the twiddles
  // W, then each consumer warpgroup's x tile and twiddle tile, then the
  // barriers: W's, and each warpgroup's x full / x empty / twiddles full /
  // twiddles empty
  static constexpr int kSmem = 1024 + kWBytes + 4 * kTileBytes + (1 + 8) * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that never
// ends (a lost arrival or copy) traps, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One bulk copy of `bytes` contiguous bytes into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// One TMA box of the 2-D tensor map at (column c0, row c1).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// The shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 1 (unused by this layout),
// 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= a (64 x 32 u8, registers) @ b (32 x N u8, shared memory), s32.
template <int N>
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_u8<8>(uint32_t (&d)[4], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_u8<16>(uint32_t (&d)[8], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_u8<32>(uint32_t (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_u8<64>(uint32_t (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int RP>
__global__ void __launch_bounds__(kThreads, 1)
    mod_matmul_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap twmap,
                      const uint8_t* __restrict__ w_smem, bool has_tw, uint32_t* __restrict__ out, int r,
                      long long b, int width, int tiles) {
  using S = Shape<RP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sw = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                                       ~static_cast<uintptr_t>(1023));
  unsigned char* sx = sw + S::kWBytes;             // x tile of warpgroup h at h * kTileBytes
  unsigned char* stw = sx + 2 * S::kTileBytes;     // its twiddle tile likewise
  const uint32_t w_bar = smem_addr(stw + 2 * S::kTileBytes);
  const auto x_full = [&](int h) { return w_bar + 8u * (1 + 4 * h); };
  const auto x_empty = [&](int h) { return w_bar + 8u * (2 + 4 * h); };
  const auto tw_full = [&](int h) { return w_bar + 8u * (3 + 4 * h); };
  const auto tw_empty = [&](int h) { return w_bar + 8u * (4 + 4 * h); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(w_bar, 1);
    for (int h = 0; h < 2; ++h) {
      mbar_init(x_full(h), 1);
      mbar_init(x_empty(h), kConsumerWarps / 2);  // the warps of warpgroup h
      mbar_init(tw_full(h), 1);
      mbar_init(tw_empty(h), kConsumerWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Consumer warpgroup h takes the block's tiles h, h + 2, ..., so that one
  // warpgroup's fragment build, folds and stores overlap the other's wgmmas;
  // producer warp kConsumerWarps + h loads them.
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread for each consumer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int h = warp - kConsumerWarps;
    if (h < 2 && lane == 0) {
      if (h == 0) {
        mbar_expect_tx(w_bar, S::kWBytes);
        bulk_load(smem_addr(sw), w_smem, S::kWBytes, w_bar);
      }
      const uint32_t tile_tx = 2u * r * kBoxCols * 4;  // two boxes of r rows
      const uint32_t x_dst = smem_addr(sx + h * S::kTileBytes), tw_dst = smem_addr(stw + h * S::kTileBytes);
      uint32_t parity = 0;
      for (int tile = blockIdx.x + h * gridDim.x; tile < tiles; tile += 2 * gridDim.x, parity ^= 1u) {
        const int col = tile * kTileCols;
        mbar_wait(x_empty(h), parity ^ 1u);
        mbar_expect_tx(x_full(h), tile_tx);
        tma_load_2d(x_dst, &xmap, col, 0, x_full(h));
        tma_load_2d(x_dst + S::kBoxBytes, &xmap, col + kBoxCols, 0, x_full(h));
        if (has_tw) {
          mbar_wait(tw_empty(h), parity ^ 1u);
          mbar_expect_tx(tw_full(h), tile_tx);
          tma_load_2d(tw_dst, &twmap, col, 0, tw_full(h));
          tma_load_2d(tw_dst + S::kBoxBytes, &twmap, col + kBoxCols, 0, tw_full(h));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int h = warp >> 2, q = warp & 3;
  const uint32_t w_base = smem_addr(sw);
  const uint32_t* x_tile = reinterpret_cast<const uint32_t*>(sx + h * S::kTileBytes);
  const uint32_t* tw_tile = reinterpret_cast<const uint32_t*>(stw + h * S::kTileBytes);
  uint32_t frag[S::kSteps][kLimbs][4];
  uint32_t acc[S::kAcc];
  uint64_t sum[S::kAcc];
#pragma unroll
  for (int e = 0; e < S::kAcc; ++e) acc[e] = 0u;
  uint32_t parity = 0;
  for (int tile = blockIdx.x + h * gridDim.x; tile < tiles; tile += 2 * gridDim.x, parity ^= 1u) {
    mbar_wait(x_full(h), parity);
    load_a_frags<RP>(x_tile, q, lane, frag);
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty(h));
    mbar_wait(w_bar, 0);  // W's planes: waited for once, then complete
    const long long j0 = static_cast<long long>(tile) * kTileCols;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < S::kAcc; ++e) sum[e] = 0u;
#pragma unroll
      for (int s = 0; s < kBuckets; ++s) {
        // this half's rows of W, opaque to the compiler so that it forms
        // the descriptors where they are used rather than holding 16 of them
        uint32_t w_addr = w_base + half * S::kNwg * 128;
        asm volatile("" : "+r"(w_addr));
#pragma unroll
        for (int e = 0; e < S::kAcc; ++e) fence_operand(acc[e]);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < kLimbs; ++a) {  // x's limb a times W's limb s - a
          const int bw = s - a;
          if (bw < 0 || bw >= kLimbs) continue;
#pragma unroll
          for (int kk = 0; kk < S::kSteps; ++kk) {
            const bool first = kk == 0 && a == (s > kLimbs - 1 ? s - (kLimbs - 1) : 0);
            wgmma_u8<S::kNwg>(acc, frag[kk][a], kmajor_desc(w_addr + bw * S::kPlaneBytes + kk * 32), first ? 0 : 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int e = 0; e < S::kAcc; ++e) {
          fence_operand(acc[e]);
          sum[e] = fold_bucket(sum[e], acc[e], byte_shift_mont(s));
        }
      }
      if (has_tw && half == 0) mbar_wait(tw_full(h), parity);
      // The epilogue. Registers 4n + c and 4n + 2 + c (c < 2) hold the
      // outputs of row k = k0 + 8n + c at the thread's two adjacent columns
      // j and j + 1, whose twiddles are adjacent words of the tile and
      // whose stores go to o0[(8n + c) * stride] and o1[...].
      int jt, k0;
      acc_coords(S::kNwg, half, q, lane, 0, jt, k0);
      const long long j = j0 + jt;
      const OutMap m0 = out_map(j, b, r, width), m1 = out_map(j + 1, b, r, width);
      const long long stride = m0.stride;  // the same for both columns
      uint32_t* o0 = out + m0.base + k0 * stride;
      uint32_t* o1 = out + m1.base + k0 * stride;
      // both columns exist, every row exists, and the pair is one aligned 8-byte store
      const bool pair = j + 1 < b && r == RP && m1.base == m0.base + 1 && (m0.base + k0 * stride) % 2 == 0 &&
                        stride % 2 == 0;
#pragma unroll
      for (int n = 0; n < S::kAcc / 4; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int dk = 8 * n + c;
          uint32_t lo = redc64(sum[4 * n + c]), hi = redc64(sum[4 * n + 2 + c]);
          if (has_tw) {
            const uint2 t = *reinterpret_cast<const uint2*>(tw_tile + x_stage_word(RP, k0 + dk, jt));
            lo = mont_mul(lo, t.x);
            hi = mont_mul(hi, t.y);
          }
          if (pair) {
            *reinterpret_cast<uint2*>(o0 + dk * stride) = make_uint2(lo, hi);
          } else if (k0 + dk < r) {
            if (j < b) o0[dk * stride] = lo;
            if (j + 1 < b) o1[dk * stride] = hi;
          }
        }
      }
    }
    if (has_tw) {
      __syncwarp();
      if (lane == 0) mbar_arrive(tw_empty(h));
    }
  }
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (so the
// library needs no link to libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of an (r, b) uint32 matrix with row pitch ld, in boxes of
// 32 columns x r rows with the 128-byte swizzle; false if the driver
// refuses it.
bool tile_map(EncodeTiled encode, CUtensorMap* map, const uint32_t* base, int r, long long b, long long ld) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(b), static_cast<cuuint64_t>(r)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(r)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<uint32_t*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int RP>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& twmap, const uint8_t* w_smem, bool has_tw,
                   uint32_t* out, int r, long long b, int width, cudaStream_t stream) {
  using S = Shape<RP>;
  // per device, once: the kernel's shared-memory limit and the SM count
  static int sms_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    e = cudaFuncSetAttribute(mod_matmul_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
    int sms = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const long long tiles = (b + kTileCols - 1) / kTileCols;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  mod_matmul_kernel<RP><<<grid, kThreads, S::kSmem, stream>>>(xmap, twmap, w_smem, has_tw, out, r, b, width,
                                                              static_cast<int>(tiles));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p, MU and the seven byte-shift constants as compiled (out: 9 words), so
// the loader can check them against the host's; returns 0.
int tapstark_matmul_constants(uint32_t* out) {
  out[0] = kP;
  out[1] = kMu;
  for (int s = 0; s < kBuckets; ++s) out[2 + s] = byte_shift_mont(s);
  return 0;
}

// w_smem: matmul_ntt.w_matrix_smem(log_r, inverse), 4 * max(2^log_r, 16) *
// 128 bytes; x: (2^log_r, b) canonical uint32 and tw: (2^log_r, b)
// Montgomery twiddles or null, both with row pitch ld (a multiple of 4,
// >= b) and 16-byte aligned; out: (2^log_r, b) canonical uint32 (width 0),
// or (b / width, 2^log_r * width) in the next level's layout, distinct
// from x. Returns a CUDA error code (cudaErrorInvalidValue for arguments
// the kernel does not take, cudaErrorNotSupported without a tensor-map
// encoder).
int tapstark_mod_matmul(const uint8_t* w_smem, const uint32_t* x, const uint32_t* tw, long long ld,
                        uint32_t* out, int log_r, long long b, int width, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (log_r < 0 || log_r > kMaxLogR || b < 1 || b >= (1ll << 31) - kTileCols || ld < b || ld % 4 != 0 ||
      width < 0 || (width > 0 && b % width != 0) || misaligned(x) || misaligned(w_smem) ||
      (tw != nullptr && misaligned(tw))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int r = 1 << log_r;
  CUtensorMap xmap, twmap;
  if (!tile_map(encode, &xmap, x, r, b, ld) || !tile_map(encode, &twmap, tw != nullptr ? tw : x, r, b, ld)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool has_tw = tw != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (padded_rows(r)) {
    case 16:
      e = launch<16>(xmap, twmap, w_smem, has_tw, out, r, b, width, s);
      break;
    case 32:
      e = launch<32>(xmap, twmap, w_smem, has_tw, out, r, b, width, s);
      break;
    case 64:
      e = launch<64>(xmap, twmap, w_smem, has_tw, out, r, b, width, s);
      break;
    default:
      e = launch<128>(xmap, twmap, w_smem, has_tw, out, r, b, width, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
