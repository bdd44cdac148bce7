// GroupNorm statistics as per-channel partial sums (csrc/temporal_resnet.cu's
// kernel A, csrc/gn_fold.cu and the two-pass path of csrc/group_norm.cu):
// for a matrix of m rows of c channels (bf16, or fp16 / f32 in group_norm.cu),
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
// Why per channel: kernel A's epilogue holds the channel columns of one N
// tile, and tiles of 128 or 160 columns split the 40-channel groups of C =
// 1280, so kernel A can only write partials per channel; fold_kernel below
// reduces the same layout for every user (group_norm_fold, the temporal
// resnet's norm2, group_norm_silu's two-pass path).
//
// fold_kernel, one block per (group, sample): the group's partials (its
// channels of every slot) summed in a fixed order, then mean, the variance
// clamped at 0 (E[x^2] - mean^2, as the JAX formula), 1 / sqrt(var + eps),
// and sc, sh (f32, per sample and channel) with GN(x) * scale + bias ==
// x * sc + sh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace gn_stats {

constexpr int kChunkRows = 64;  // rows of a chunk: a GEMM consumer warpgroup's
constexpr int kThreads = 256;

inline int slots(int rows_per_sample) {
  return (rows_per_sample + kChunkRows - 1) / kChunkRows + 1;
}

// two neighbouring elements as f32
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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
  // (r0 % 64 == 0) of a row-major matrix, src pointing at (r0, col) and ld
  // elements a row: summed in row order, split where a sample ends.
  template <typename T>
  __device__ __forceinline__ void chunk(const T* src, int ld, int r0, int m, int col) const {
    const int q = r0 / kChunkRows, r1 = min(r0 + kChunkRows, m);
    int b = r0 / rows_per_sample;
    int next = (b + 1) * rows_per_sample;  // the next sample's first row
    float2 s = make_float2(0.f, 0.f), s2 = s;
    auto add = [&](int r) {
      const float2 v = load_pair(src + (size_t)(r - r0) * ld);
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

// the statistics of a (m, c) matrix in device memory, one column pair of one
// chunk a thread; with x2, of the channel concat [x, x2] of x's first c1
// columns and x2's c - c1 (c1 even), never built: a pair reads the part it
// lies in
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, const T* __restrict__ x2, const Stats st, int m, int c1) {
  const int pairs = st.c / 2;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long chunks = (m + kChunkRows - 1) / kChunkRows;
  if (i >= chunks * pairs) return;
  const int q = static_cast<int>(i / pairs), p = static_cast<int>(i - (long long)q * pairs);
  const int r0 = q * kChunkRows, col = 2 * p;
  if (col < c1)
    st.chunk(x + (size_t)r0 * c1 + col, c1, r0, m, col);
  else
    st.chunk(x2 + (size_t)r0 * (st.c - c1) + (col - c1), st.c - c1, r0, m, col);
}

// stats_kernel over x of element type T (c even, x aligned to two
// elements), or over the concat [x, x2] (x holding the first c1 channels,
// c1 even); returns cudaGetLastError()
template <typename T = __nv_bfloat16>
inline int launch(const void* x, const Stats& st, int m, cudaStream_t s,
                  const void* x2 = nullptr, int c1 = 0) {
  const long long threads = (long long)(m + kChunkRows - 1) / kChunkRows * (st.c / 2);
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  stats_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x),
                                              static_cast<const T*>(x2), st, m,
                                              x2 == nullptr ? st.c : c1);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
            const float* __restrict__ scale, const float* __restrict__ bias,
            float* __restrict__ sc, float* __restrict__ sh, int slots, int c, int gs,
            float denom, float eps) {
  const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const size_t base = (size_t)b * slots * c + (size_t)g * gs;
  float s = 0.f, s2 = 0.f;
  for (int i = t; i < slots * gs; i += kFoldThreads) {
    const int slot = i / gs, j = i - slot * gs;
    const size_t o = base + (size_t)slot * c + j;
    s += psum[o];
    s2 += psq[o];
  }
  __shared__ float red[2][kFoldThreads];
  red[0][t] = s;
  red[1][t] = s2;
  __syncthreads();
  for (int h = kFoldThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      red[0][t] += red[0][t + h];
      red[1][t] += red[1][t + h];
    }
    __syncthreads();
  }
  const float mean = red[0][0] / denom;
  const float var = fmaxf(red[1][0] / denom - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  for (int j = t; j < gs; j += kFoldThreads) {
    const int ch = g * gs + j;
    const float a = inv * scale[ch];
    sc[(size_t)b * c + ch] = a;
    sh[(size_t)b * c + ch] = bias[ch] - mean * a;
  }
}

// fold_kernel: sc, sh (b, c) f32 from the partials of b samples of
// rows_per_sample rows (st's) and scale, bias (c) f32; returns
// cudaGetLastError()
inline int fold(const Stats& st, int b, int groups, const void* scale, const void* bias,
                void* sc, void* sh, float eps, cudaStream_t s) {
  const int gs = st.c / groups;
  fold_kernel<<<dim3(groups, b), kFoldThreads, 0, s>>>(
      st.sum, st.sq, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(sc), static_cast<float*>(sh), st.slots, st.c, gs,
      static_cast<float>((double)st.rows_per_sample * gs), eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn_stats
}  // namespace
