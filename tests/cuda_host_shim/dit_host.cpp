// The DIT and DIF kernels of tapstark_torch/csrc/dit_cols.cuh and
// dif_cols.cuh run on the host: the grid's blocks one after another, each
// block's threads as std::threads. The arguments, checks and launch shapes
// are the headers' own (dit_first_args, dit_first_shape, dit_cols_shape,
// dif_last_args, dif_last_shape, dif_cols_shape), as in the launch_*
// functions; the card's SM count is an argument of host_dif_cols.
#include <cstring>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim;
std::barrier<>* host_block_barrier;

namespace {
// the block's dynamic shared memory, under each header's name
alignas(16) uint32_t dit_sm[1 << 16];
alignas(16) uint32_t dif_sm[1 << 16];
}  // namespace

#include "dif_cols.cuh"
#include "dit_cols.cuh"

namespace {

template <class Kernel>
void run_grid(dim3 grid, int threads, const Kernel& kernel) {
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(dit_sm, 0xA5, sizeof(dit_sm));  // no block sees another's data
      std::memset(dif_sm, 0xA5, sizeof(dif_sm));
      std::barrier<> bar(threads);
      host_block_barrier = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t) {
        ts.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          kernel();
        });
      }
      for (auto& t : ts) t.join();
    }
  }
}

}  // namespace

extern "C" {

int host_dit_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r, long long b) {
  DitShape d;
  if (!dit_cols_shape(log_r, b, d)) return 1;
  if (d.smem > sizeof(dit_sm)) return 2;
  const uint2* tw2 = reinterpret_cast<const uint2*>(tw);
  run_grid(dim3(static_cast<unsigned>(d.lane_blocks)), d.threads,
           [&] { dit_cols_kernel(src, dst, tw2, log_r, b, d.log_l); });
  return 0;
}

int host_dit_first(const uint32_t* x, long long x_row, long long x_col, uint32_t* out,
                   const uint32_t* tw, const uint32_t* s1, const uint32_t* s2, const uint32_t* hi,
                   const uint32_t* lo, int log_r, int log_c, int h, int log_blowup, int width) {
  DitFirstArgs a = dit_first_args(x, x_row, x_col, out, tw, s1, s2, hi, lo, log_r, log_c, h,
                                  log_blowup, width);
  DitShape d;
  if (!dit_first_shape(a, d)) return 1;
  if (d.smem > sizeof(dit_sm)) return 2;
  run_grid(dim3(1u << log_c, static_cast<unsigned>(d.lane_blocks)), d.threads,
           [&] { dit_first_kernel(a); });
  return 0;
}

int host_dif_cols(const uint32_t* src, uint32_t* dst, const uint32_t* tw, int log_r, long long b,
                  int sms) {
  DitShape d;
  if (!dif_cols_shape(log_r, b, 2ll * sms, d)) return 1;
  if (d.smem > sizeof(dif_sm)) return 2;
  const uint2* tw2 = reinterpret_cast<const uint2*>(tw);
  run_grid(dim3(static_cast<unsigned>(d.lane_blocks)), d.threads,
           [&] { dif_cols_kernel(src, dst, tw2, log_r, b, d.log_l); });
  return 0;
}

int host_dif_last(const uint32_t* a, uint32_t* out, long long out_row, long long out_col,
                  const uint32_t* tw, const uint32_t* hi, const uint32_t* lo, uint32_t c0, int log_r,
                  int log_c, int h, int width) {
  DifLastArgs args = dif_last_args(a, out, out_row, out_col, tw, hi, lo, c0, log_r, log_c, h, width);
  DitShape d;
  if (!dif_last_shape(args, d)) return 1;
  if (d.smem > sizeof(dif_sm)) return 2;
  run_grid(dim3(1u << log_r, static_cast<unsigned>(d.lane_blocks)), d.threads,
           [&] { dif_last_kernel(args); });
  return 0;
}

}  // extern "C"
