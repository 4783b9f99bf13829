// BabyBear arithmetic shared by the port's NTT kernels (dit_cols.cuh,
// dif_cols.cuh and their entry points in ntt_cols.cu, matmul_ntt.cu).
//
// Field words are Montgomery form (x * 2^32 mod p) or canonical values in
// uint32, p = 15*2^27+1, exactly the words of tapstark_torch.field.device.
// A product is one 32x32->64 multiply and a REDC with MU = -p^{-1} mod 2^32
// (tapstark_torch/field/constants.py) instead of the TPU's 16-bit limb
// products; every result is in [0, p). The column kernels also multiply by
// canonical twiddles with Shoup companions ws = floor(w * 2^32 / p), lazily:
// w * x mod p = w * x - mulhi(ws, x) * p (mod 2^32), in [0, 2p) for any
// x < 2^32, one __umulhi instead of the TPU's 16-bit limb emulation.

#pragma once

#include <cstdint>

namespace {

constexpr uint32_t kP = 0x78000001u;
constexpr uint32_t kMu = 0x77ffffffu;  // -p^{-1} mod 2^32

// a * b * 2^-32 mod p, for a * b < p * 2^32.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t hi = static_cast<uint32_t>(t >> 32);
  const uint32_t m = lo * kMu;
  const uint32_t u = hi + __umulhi(m, kP) + (lo != 0u);
  return u >= kP ? u - kP : u;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a - b + kP;
}

// [0, 2p) -> [0, p).
__device__ __forceinline__ uint32_t reduce2p(uint32_t x) { return x >= kP ? x - kP : x; }

// w * x mod p in [0, 2p): wc canonical, ws its Shoup companion, x < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t wc, uint32_t ws, uint32_t x) {
  return wc * x - __umulhi(ws, x) * kP;
}

}  // namespace
