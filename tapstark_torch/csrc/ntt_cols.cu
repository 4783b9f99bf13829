// The entry points of the column NTTs over BabyBear on Hopper (sm_90a):
// every NTT launch of the port's LDE routes (tapstark_torch/poly/cols_ntt.py
// and cuda_ntt.py) goes through them.
//
// Replaces the TPU kernels of tapstark/poly/pallas_ntt.py:
//   dit_cols  <- _butterfly_kernel     (K3, via _ntt_cols_pallas): DIT down
//                axis 0 of an (R, B) matrix, rows bit-reversed in, natural
//                out; in two forms (dit_cols.cuh says how each works):
//     - the plain column form (tapstark_dit_cols), and
//     - the first member of a forward coset LDE (tapstark_dit_first), with
//       the glue of the blocks route's forward half taken in: the block
//       scale (and 1/n) on load, the outer twiddle on store, both
//       transposes in the addressing;
//     the same two entry points run lde_forward (K2's counterpart) on
//     lde_inverse's (w, n) layout;
//   dif_cols  <- _dif_butterfly_kernel (K4, via _dif_cols_pallas): DIF,
//                natural in, bit-reversed out; in two forms (dif_cols.cuh
//                says how each works):
//     - the plain column form (tapstark_dif_cols), and
//     - the last member of an inverse transform to bitrev_n order
//       (tapstark_dif_last), with the glue of the blocks route's inverse
//       half taken in: the outer twiddle (and 1/n) on load, both
//       transposes in the addressing;
//     the same two entry points run lde_inverse (K1's counterpart,
//     _fused_intt_kernel) on the natural (n, w) evaluations, writing (w, n).
//
// What bounds them, and the design: dit_cols.cuh and dif_cols.cuh. The
// largest R in one pass is 2^kDitMaxLogR = 2^14 for both directions,
// which covers the four-step split of every size up to the field's 2^27;
// larger R is refused.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "dif_cols.cuh"
#include "dit_cols.cuh"

extern "C" {

// p and MU as compiled, so the loader can check them against the field's.
void tapstark_field_constants(uint32_t* out) {
  out[0] = kP;
  out[1] = kMu;
}

// The largest log R one launch takes.
int tapstark_ntt_cols_max_log_r() { return kDitMaxLogR; }

// src, dst: (2^log_r, b) row-major uint32 (Montgomery words), distinct.
// DIF, natural rows in, bit-reversed out (K4's column form). tw: (2^log_r
// - 1) pairs of dit_tables.dit_stage_pairs of the direction wanted.
int tapstark_dif_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r,
                      long long b, void* stream) {
  return static_cast<int>(launch_dif_cols(src, dst, reinterpret_cast<const uint2*>(tw), log_r, b,
                                          static_cast<cudaStream_t>(stream)));
}

// The last member of an inverse transform (K4's fused form, and K1's
// second launch): a holds the column form's output, (2^log_r, 2^log_c *
// width); position p1*C + p2 (bitrev_n order) of column c goes to
// out[(p1*C + p2) * out_row + c * out_col], times c0 (Montgomery 1/n or
// 1). The tables are those of dit_tables.last_member_tables; h = log2 of
// lo's length.
int tapstark_dif_last(const uint32_t* a, uint32_t* out, long long out_row, long long out_col,
                      const uint32_t* tw, const uint32_t* hi, const uint32_t* lo, uint32_t c0,
                      int log_r, int log_c, int h, int width, void* stream) {
  return static_cast<int>(launch_dif_last(
      dif_last_args(a, out, out_row, out_col, tw, hi, lo, c0, log_r, log_c, h, width),
      static_cast<cudaStream_t>(stream)));
}

// src, dst: (2^log_r, b) as above, distinct. DIT, bit-reversed rows in,
// natural out (K3's column form). tw: (2^log_r - 1) pairs of
// dit_tables.dit_stage_pairs of the direction wanted.
int tapstark_dit_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r,
                      long long b, void* stream) {
  return static_cast<int>(launch_dit_cols(src, dst, reinterpret_cast<const uint2*>(tw), log_r, b,
                                          static_cast<cudaStream_t>(stream)));
}

// The first member of a forward coset LDE (K3's fused form, and K2's first
// launch): x holds n = 2^(log_r + log_c) coefficients in bitrev_n order of
// `width` columns, coefficient j of column c at x[j * x_row + c * x_col];
// out: (2^log_c, 2^log_r * 2^log_blowup * width), B[p2, (k1, rb, c)]. The
// tables are those of dit_tables.first_member_tables; h = log2 of lo's
// length.
int tapstark_dit_first(const uint32_t* x, long long x_row, long long x_col, uint32_t* out,
                       const uint32_t* tw, const uint32_t* s1, const uint32_t* s2,
                       const uint32_t* hi, const uint32_t* lo, int log_r, int log_c, int h,
                       int log_blowup, int width, void* stream) {
  return static_cast<int>(launch_dit_first(
      dit_first_args(x, x_row, x_col, out, tw, s1, s2, hi, lo, log_r, log_c, h, log_blowup, width),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
