// GroupNorm statistics as per-channel partial sums (csrc/temporal_resnet.cu's
// kernel A and csrc/gn_fold.cu): for a matrix of m rows of c bf16 channels,
// a sample being rows_per_sample consecutive rows, f32 sums and sums of
// squares per (sample, 64-row chunk, channel) in a (B, slots, c) buffer
// each, slots = ceil(rows_per_sample / 64) + 1. Slot j of sample b holds its
// rows of chunk first_chunk(b) + j, first_chunk(b) = b * rows_per_sample /
// 64: a chunk that straddles samples (wherever rows_per_sample % 64 != 0)
// holds a partial of each, and a sample's slots past its last chunk are
// written as zeros. Each column pair of a chunk is summed by one thread in
// row order, so the partials are the same bits whoever computes them (kernel
// A's epilogue from its tile in shared memory, stats_kernel from device
// memory). No atomics: a fold reduces the slots in a fixed order.
//
// Why per channel, beside the per-group partials of the Triton stats_kernel
// in ops/kernels/groupnorm.py (group_norm_silu): kernel A's epilogue holds
// the channel columns of one N tile, and tiles of 128 or 160 columns split
// the 40-channel groups of C = 1280, so kernel A can only write partials per
// channel; the fold reads the same layout, so one fold kernel serves it and
// group_norm_fold. group_norm_silu keeps its own pair: its norm kernel reads
// a sample's group partials (groups x splits, a few hundred floats) in every
// program, where this layout would give it slots x C. Moving it onto these
// partials is open work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace gn_stats {

constexpr int kChunkRows = 64;  // rows of a chunk: a GEMM consumer warpgroup's
constexpr int kThreads = 256;

inline int slots(int rows_per_sample) {
  return (rows_per_sample + kChunkRows - 1) / kChunkRows + 1;
}

struct Stats {
  float* sum;
  float* sq;
  int c, rows_per_sample, slots;

  __device__ __forceinline__ void flush(int b, int q, int r0, float2 s, float2 s2,
                                        int col) const {
    const int slot = q - static_cast<int>((long long)b * rows_per_sample / kChunkRows);
    const size_t o = ((size_t)b * slots + slot) * c + col;
    *reinterpret_cast<float2*>(sum + o) = s;
    *reinterpret_cast<float2*>(sq + o) = s2;
    // the sample's last chunk: its later slots hold nothing
    if ((long long)(b + 1) * rows_per_sample <= r0 + kChunkRows)
      for (int j = slot + 1; j < slots; ++j) {
        const size_t z = ((size_t)b * slots + j) * c + col;
        *reinterpret_cast<float2*>(sum + z) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(sq + z) = make_float2(0.f, 0.f);
      }
  }

  // Columns (col, col + 1) of the rows [r0, min(r0 + 64, m)) of one chunk
  // (r0 % 64 == 0) of a row-major bf16 matrix, src pointing at (r0, col) and
  // ld elements a row: summed in row order, split where a sample ends.
  __device__ __forceinline__ void chunk(const __nv_bfloat16* src, int ld, int r0, int m,
                                        int col) const {
    const int q = r0 / kChunkRows, r1 = min(r0 + kChunkRows, m);
    int b = r0 / rows_per_sample;
    int next = (b + 1) * rows_per_sample;  // the next sample's first row
    float2 s = make_float2(0.f, 0.f), s2 = s;
    auto add = [&](int r) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)(r - r0) * ld));
      s.x += v.x;
      s.y += v.y;
      s2.x = fmaf(v.x, v.x, s2.x);
      s2.y = fmaf(v.y, v.y, s2.y);
    };
    if (r1 == r0 + kChunkRows && next >= r1) {
      // the whole chunk in one sample (most chunks): no boundary to look for
#pragma unroll 16
      for (int r = r0; r < r1; ++r) add(r);
    } else {
      for (int r = r0; r < r1; ++r) {
        if (r == next) {
          flush(b, q, r0, s, s2, col);
          ++b;
          next += rows_per_sample;
          s = s2 = make_float2(0.f, 0.f);
        }
        add(r);
      }
    }
    flush(b, q, r0, s, s2, col);
  }
};

// the statistics of a (m, c) bf16 matrix in device memory, one column pair
// of one chunk a thread
__global__ void __launch_bounds__(kThreads)
stats_kernel(const __nv_bfloat16* __restrict__ x, const Stats st, int m) {
  const int pairs = st.c / 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long chunks = (m + kChunkRows - 1) / kChunkRows;
  if (i >= chunks * pairs) return;
  const int q = static_cast<int>(i / pairs), p = static_cast<int>(i - (long long)q * pairs);
  const int r0 = q * kChunkRows;
  st.chunk(x + (size_t)r0 * st.c + 2 * p, st.c, r0, m, 2 * p);
}

// stats_kernel over x (c even, x 4-byte aligned); returns cudaGetLastError()
inline int launch(const void* x, const Stats& st, int m, cudaStream_t s) {
  const long long threads = (long long)(m + kChunkRows - 1) / kChunkRows * (st.c / 2);
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  stats_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), st, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn_stats
}  // namespace
