// The limb-matmul kernel's data flow (tapstark_torch/csrc/matmul_ntt.cu) on
// the host, through the header's own functions (matmul_ntt.cuh): the stage
// layout the TMA boxes fill, the A fragments each consumer lane builds,
// the buckets folded into 64-bit sums, the one reduction, the twiddle and
// both store forms. The hardware is modelled by its documented layouts:
// a TMA box of x or of the twiddles writes rows r..RP-1 never (here: stale
// bytes) and columns past b as zeros; wgmma m64nNk32 (u8 x u8 -> s32) takes A element (m, k)
// from byte k % 4 of register 2 (k / 16) + (m / 8) % 2 of lane
// 4 (m % 8) + (k % 16) / 4 of warp m / 16, B element (k, n) from byte
// w_plane_byte(n0 + n, k) of the limb plane, and leaves D element (m, n)
// in register 4 (n / 8) + 2 ((m / 8) % 2) + n % 2 of lane 4 (m % 8) +
// (n % 8) / 2 of warp m / 16.
#include <cstring>
#include <vector>

#include "cuda_runtime.h"
#include "matmul_ntt.cuh"

namespace {

template <int RP>
void run(const uint8_t* w_smem, const uint32_t* x, const uint32_t* tw, uint32_t* out, int r, long long b,
         int width) {
  constexpr int ks = k_steps(RP), nwg = RP / 2, nacc = nwg / 2, kdepth = 32 * ks;
  std::vector<uint32_t> stage(2 * RP * kBoxCols), tw_stage(2 * RP * kBoxCols);
  using Frag = uint32_t[ks][kLimbs][4];
  std::vector<Frag> frag(4 * 32);
  std::vector<uint8_t> a_mat(kLimbs * 64 * kdepth);
  std::vector<int32_t> d(64 * nwg);
  std::vector<uint64_t> sum(4 * 32 * nacc);
  for (long long j0 = 0; j0 < b; j0 += kTileCols) {
    std::memset(stage.data(), 0xA5, stage.size() * 4);
    std::memset(tw_stage.data(), 0xA5, tw_stage.size() * 4);
    for (int i = 0; i < r; ++i) {
      for (int jt = 0; jt < kTileCols; ++jt) {
        stage[x_stage_word(RP, i, jt)] = j0 + jt < b ? x[i * b + j0 + jt] : 0u;
        if (tw) tw_stage[x_stage_word(RP, i, jt)] = j0 + jt < b ? tw[i * b + j0 + jt] : 0u;
      }
    }
    for (int half = 0; half < 2; ++half) {  // the two halves of the output rows
      for (int lane = 0; lane < 4 * 32; ++lane) load_a_frags<RP>(stage.data(), lane / 32, lane % 32, frag[lane]);
      for (int q = 0; q < 4; ++q) {
        for (int lane = 0; lane < 32; ++lane) {
          for (int kk = 0; kk < ks; ++kk) {
            for (int a = 0; a < kLimbs; ++a) {
              for (int reg = 0; reg < 4; ++reg) {
                for (int byte = 0; byte < 4; ++byte) {
                  const int m = 16 * q + lane / 4 + 8 * (reg % 2);
                  const int k = 32 * kk + 16 * (reg / 2) + 4 * (lane % 4) + byte;
                  a_mat[(a * 64 + m) * kdepth + k] = (frag[32 * q + lane][kk][a][reg] >> (8 * byte)) & 0xff;
                }
              }
            }
          }
        }
      }
      std::fill(sum.begin(), sum.end(), 0);
      for (int s = 0; s < kBuckets; ++s) {
        std::fill(d.begin(), d.end(), 0);
        for (int a = 0; a < kLimbs; ++a) {
          const int bw = s - a;
          if (bw < 0 || bw >= kLimbs) continue;
          const uint8_t* plane = w_smem + bw * RP * 128;
          for (int m = 0; m < 64; ++m) {
            for (int n = 0; n < nwg; ++n) {
              for (int k = 0; k < kdepth; ++k) {
                d[m * nwg + n] += a_mat[(a * 64 + m) * kdepth + k] * plane[w_plane_byte(half * nwg + n, k)];
              }
            }
          }
        }
        for (int lane = 0; lane < 4 * 32; ++lane) {
          const int q = lane / 32, g = (lane % 32) / 4, t = lane % 4;
          for (int e = 0; e < nacc; ++e) {
            const int m = 16 * q + g + 8 * ((e / 2) % 2), n = 8 * (e / 4) + 2 * t + e % 2;
            sum[lane * nacc + e] = fold_bucket(sum[lane * nacc + e], d[m * nwg + n], byte_shift_mont(s));
          }
        }
      }
      for (int lane = 0; lane < 4 * 32; ++lane) {
        for (int e = 0; e < nacc; ++e) {
          int jt, k;
          acc_coords(nwg, half, lane / 32, lane % 32, e, jt, k);
          const long long j = j0 + jt;
          if (k < r && j < b) {
            uint32_t v = redc64(sum[lane * nacc + e]);
            if (tw) v = mont_mul(v, tw_stage[x_stage_word(RP, k, jt)]);
            const OutMap map = out_map(j, b, r, width);
            out[map.base + k * map.stride] = v;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// mod_matmul as the kernel computes it: w_smem = matmul_ntt.w_matrix_smem
// (log_r, inverse), x (2^log_r, b) canonical, tw (2^log_r, b) Montgomery
// or null, out in the natural form (width 0) or the next level's.
int host_mod_matmul(const uint8_t* w_smem, const uint32_t* x, const uint32_t* tw, uint32_t* out, int log_r,
                    long long b, int width) {
  if (log_r < 0 || log_r > kMaxLogR || b < 1 || width < 0 || (width > 0 && b % width != 0)) return 1;
  const int r = 1 << log_r;
  switch (padded_rows(r)) {
    case 16:
      run<16>(w_smem, x, tw, out, r, b, width);
      break;
    case 32:
      run<32>(w_smem, x, tw, out, r, b, width);
      break;
    case 64:
      run<64>(w_smem, x, tw, out, r, b, width);
      break;
    default:
      run<128>(w_smem, x, tw, out, r, b, width);
  }
  return 0;
}

// The epilogue alone: out[i] = the one reduction of sum_s buckets[i][s] *
// mont(2^(8s)), for n outputs of 7 bucket sums each.
void host_fold_buckets(const uint32_t* buckets, uint32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    uint64_t t = 0;
    for (int s = 0; s < kBuckets; ++s) t = fold_bucket(t, buckets[i * kBuckets + s], byte_shift_mont(s));
    out[i] = redc64(t);
  }
}

}  // extern "C"
