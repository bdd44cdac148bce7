// GroupNorm statistics as per-channel partial sums, and their fold into the
// per-(sample, channel) affine (sc, sh), in the launch that writes the
// partials (csrc/temporal_resnet.cu's kernel A, csrc/gn_fold.cu and the
// two-pass path of csrc/group_norm.cu).
//
// The partials: for a matrix of m rows of c channels (bf16, or fp16 / f32 in
// group_norm.cu), a sample being rows_per_sample consecutive rows, f32 sums
// and sums of squares per (sample, 64-row chunk, channel) in a (B, slots, c)
// buffer each, slots = ceil(rows_per_sample / 64) + 1. Slot j of sample b
// holds its rows of chunk first_chunk(b) + j, first_chunk(b) = b *
// rows_per_sample / 64: a chunk that straddles samples (wherever
// rows_per_sample % 64 != 0) holds a partial of each, and a sample's slots
// past its last chunk are written as zeros. Each column of a chunk is summed
// by one thread in row order, so the partials are the same bits whoever
// computes them (kernel A's epilogue from its tile in shared memory, two
// columns a thread; stats_kernel from device memory, 16 bytes a thread).
//
// Why per channel: kernel A's epilogue holds the channel columns of one N
// tile, and tiles of 128 or 160 columns split the 40-channel groups of C =
// 1280, so kernel A can only write partials per channel.
//
// The fold, with no launch of its own: once every partial of the launch is
// written, one grid-wide barrier (counters in a workspace per (device,
// stream), made once: ops/kernels/groupnorm.py), then the fold, one
// (sample, group) at a time on each unit of 256 threads (a stats_kernel
// block; kernel A's two consumer warpgroups): thread t sums the group's
// values i = t, t + 256, ... of the sample's partials in (slot, channel)
// order, a tree in shared memory halves the 256 sums in a fixed order, then
// mean, the variance clamped at 0 (E[x^2] - mean^2, the JAX formula),
// 1 / sqrt(var + eps), and sc, sh with GN(x) * scale + bias == x * sc + sh.
// That is the order of the launch the fold replaces (one block per (group,
// sample)), so sc and sh are the same bits as before it, on every run,
// whatever unit folds, and whether kernel A's epilogue or stats_kernel
// wrote the partials; no float atomics. The barrier needs every block of
// the grid resident: kernel A is persistent, one block an SM, and
// stats_kernel walks the chunks with at most the card's resident blocks;
// both are cooperative launches. The last block out resets the barrier's
// counters, so the launches replay in CUDA graphs.
//
// Measured against it (PERF.md §6; scripts/bench_fold.py, NVIDIA
// H100 80GB HBM3, 700.00 W): tickets without a barrier (the block, or
// kernel A's warpgroup, whose atomic add completed a segment of a sample
// reduced it, the one that completed the sample folded it) took 0.0341 ms
// at the L0 temporal x against the two launches' 0.0255 and made kernel A
// ~0.12 ms slower at L0 (a fence and an atomic every tile, chains of
// dependent L2 reads at the end); warps over (sample, segment, group) items
// after the barrier, 0.0266-0.0288 ms, but at other bits than the launch
// they replace (the f32 sums in another order moved the videos' rel-L2 in
// the third digit).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {
namespace gn_stats {

constexpr int kChunkRows = 64;     // rows of a chunk: a GEMM consumer warpgroup's
constexpr int kFoldThreads = 256;  // a fold unit: a (sample, group) at a time
constexpr int kArrive = 0, kExit = 32;  // the workspace's words

__host__ __device__ inline int slots(int rows_per_sample) {
  return (rows_per_sample + kChunkRows - 1) / kChunkRows + 1;
}
// 16 bytes of T as kN f32 (the statistics pass's loads), and one bf16 pair
// (kernel A's read-back from its tile)
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8, kUnroll = 8, kMinBlocks = 2;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float (&v)[kN]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<__half> {
  static constexpr int kN = 8, kUnroll = 8, kMinBlocks = 2;
  __device__ static __forceinline__ void load(const __half* p, float (&v)[kN]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4, kUnroll = 8, kMinBlocks = 2;
  __device__ static __forceinline__ void load(const float* p, float (&v)[kN]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};
// one bf16 pair: from device memory 32 rows in flight, where a call's
// chunks are too few for 16-byte vectors to keep the card's memory busy;
// from kernel A's tile in shared memory 16
template <int kRowsInFlight, int kBlocks>
struct Pair {
  static constexpr int kN = 2, kUnroll = kRowsInFlight, kMinBlocks = kBlocks;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float (&v)[kN]) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
};
using PairBf16 = Pair<32, 4>;
using PairBf16Tile = Pair<16, 1>;

template <int kN>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kN]) {
  if constexpr (kN == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

struct Stats {
  float* sum;
  float* sq;
  int c, rows_per_sample, slots;

  template <int kN>
  __device__ __forceinline__ void flush(int b, int q, int r0, const float (&s)[kN],
                                        const float (&s2)[kN], int col) const {
    const int slot = q - static_cast<int>((long long)b * rows_per_sample / kChunkRows);
    const size_t o = ((size_t)b * slots + slot) * c + col;
    store_vec<kN>(sum + o, s);
    store_vec<kN>(sq + o, s2);
    // the sample's last chunk: its later slots hold nothing
    if ((long long)(b + 1) * rows_per_sample <= r0 + kChunkRows) {
      float z[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) z[i] = 0.f;
      for (int j = slot + 1; j < slots; ++j) {
        const size_t o2 = ((size_t)b * slots + j) * c + col;
        store_vec<kN>(sum + o2, z);
        store_vec<kN>(sq + o2, z);
      }
    }
  }

  // Columns col .. col + L::kN - 1 of the rows [r0, min(r0 + 64, m)) of one
  // chunk (r0 % 64 == 0) of a row-major matrix, src pointing at (r0, col)
  // and ld elements a row: each column summed in row order, split where a
  // sample ends.
  template <class L, typename T>
  __device__ __forceinline__ void chunk(const T* src, int ld, int r0, int m, int col) const {
    constexpr int kN = L::kN;
    const int q = r0 / kChunkRows, r1 = min(r0 + kChunkRows, m);
    int b = r0 / rows_per_sample;
    int next = (b + 1) * rows_per_sample;  // the next sample's first row
    float s[kN], s2[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) s[i] = s2[i] = 0.f;
    auto add = [&](int r) {
      float v[kN];
      L::load(src + (size_t)(r - r0) * ld, v);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        s[i] += v[i];
        s2[i] = fmaf(v[i], v[i], s2[i]);
      }
    };
    if (r1 == r0 + kChunkRows && next >= r1) {
      // the whole chunk in one sample (most chunks): no boundary to look for
      for (int r = r0; r < r1; r += L::kUnroll) {
#pragma unroll
        for (int u = 0; u < L::kUnroll; ++u) add(r + u);
      }
    } else {
      for (int r = r0; r < r1; ++r) {
        if (r == next) {
          flush<kN>(b, q, r0, s, s2, col);
          ++b;
          next += rows_per_sample;
#pragma unroll
          for (int i = 0; i < kN; ++i) s[i] = s2[i] = 0.f;
        }
        add(r);
      }
    }
    flush<kN>(b, q, r0, s, s2, col);
  }
};

// What the fold needs beyond the partials (see the top of the file).
struct Fold {
  unsigned* bar;        // the stream's barrier words
  const void* scale;    // (c) f32, or bf16 where affine_bf16 (read as they are)
  const void* bias;
  float* sc;            // (b, c) f32 out
  float* sh;
  int b, groups, affine_bf16;
  float denom, eps;     // rows_per_sample * c / groups; GroupNorm's eps

  __device__ __forceinline__ float affine(const void* p, int ch) const {
    return affine_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[ch])
                       : static_cast<const float*>(p)[ch];
  }
};

inline Fold make_fold(void* bar, const void* scale, const void* bias, void* sc, void* sh, int b,
                      int rows_per_sample, int c, int groups, float eps, int affine_bf16 = 0) {
  return Fold{static_cast<unsigned*>(bar), scale, bias, static_cast<float*>(sc),
              static_cast<float*>(sh), b, groups, affine_bf16 != 0,
              static_cast<float>((double)rows_per_sample * (c / groups)), eps};
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every participating thread of every block of the grid: `sync` is the
// block's barrier over its participating threads, and `leader` one of them
// arrives for the block (a release add) and waits until every block has. A
// wait that never ends traps, so the launch fails instead of hanging the
// card. The count stays until every block is past it: leave() resets it.
template <class Sync>
__device__ __forceinline__ void grid_barrier(unsigned* bar, const Sync& sync, bool leader) {
  sync();
  if (leader) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar + kArrive) : "memory");
    for (uint32_t polls = 0; ld_acquire(bar + kArrive) < gridDim.x; ++polls) {
      __nanosleep(20);
      if (polls == (1u << 26)) __trap();
    }
  }
  sync();
}

// the leader of every block, past the barrier: the last out resets the
// count for the next launch
__device__ __forceinline__ void leave(unsigned* bar) {
  unsigned out;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
               : "=r"(out)
               : "l"(bar + kExit)
               : "memory");
  if (out == gridDim.x - 1) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar + kArrive) : "memory");
    asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar + kExit) : "memory");
  }
}

// The fold (see the top of the file) on unit `unit` of `units` in the grid,
// every thread of every unit calling it, `red` 2 x 256 floats of the unit's
// shared memory, `sync` the unit's barrier; `barrier` first where the
// partials were written by this launch.
template <class Sync>
__device__ __forceinline__ void fold_phase(const Stats& st, const Fold& fd, int unit, int units,
                                           int t, float (*red)[kFoldThreads], const Sync& sync,
                                           bool barrier) {
  if (barrier) {
    grid_barrier(fd.bar, sync, t == 0);
    if (t == 0) leave(fd.bar);
  }
  const int gs = st.c / fd.groups;
  for (int it = unit; it < fd.b * fd.groups; it += units) {
    const int g = it % fd.groups, b = it / fd.groups;
    const size_t base = (size_t)b * st.slots * st.c + (size_t)g * gs;
    float s = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int i = t; i < st.slots * gs; i += kFoldThreads) {
      const int slot = i / gs, j = i - slot * gs;
      const size_t o = base + (size_t)slot * st.c + j;
      s += __ldcg(st.sum + o);
      s2 += __ldcg(st.sq + o);
    }
    red[0][t] = s;
    red[1][t] = s2;
    sync();
    for (int h = kFoldThreads / 2; h > 0; h >>= 1) {
      if (t < h) {
        red[0][t] += red[0][t + h];
        red[1][t] += red[1][t + h];
      }
      sync();
    }
    const float mean = red[0][0] / fd.denom;
    const float var = fmaxf(red[1][0] / fd.denom - mean * mean, 0.f);
    const float inv = rsqrtf(var + fd.eps);
    for (int j = t; j < gs; j += kFoldThreads) {
      const int ch = g * gs + j;
      const float a = inv * fd.affine(fd.scale, ch);
      fd.sc[(size_t)b * st.c + ch] = a;
      fd.sh[(size_t)b * st.c + ch] = fd.affine(fd.bias, ch) - mean * a;
    }
    sync();  // red is free
  }
}

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The statistics of a (m, c) matrix in device memory and their fold: a
// thread takes one column vector (L::kN channels) of one chunk at a time,
// walking (chunk, vector) by the grid, 256 threads a block; with x2, of the
// channel concat [x, x2] of x's first c1 columns and x2's c - c1, never
// built: a vector reads the part it lies in. With x null the partials are
// given (fold_from_partials) and the blocks only fold.
constexpr int kThreads = kFoldThreads;

template <typename T, class L>
__global__ void __launch_bounds__(kThreads, L::kMinBlocks)
stats_kernel(const T* __restrict__ x, const T* __restrict__ x2, const Stats st, const Fold fd,
             int m, int c1) {
  const int vecs = st.c / L::kN;
  const long long items = (long long)((m + kChunkRows - 1) / kChunkRows) * vecs;
  if (x != nullptr)
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < items;
         i += (long long)gridDim.x * kThreads) {
      const int q = static_cast<int>(i / vecs), col = static_cast<int>(i % vecs) * L::kN;
      const int r0 = q * kChunkRows;
      if (col < c1)
        st.chunk<L>(x + (size_t)r0 * c1 + col, c1, r0, m, col);
      else
        st.chunk<L>(x2 + (size_t)r0 * (st.c - c1) + (col - c1), st.c - c1, r0, m, col);
    }
  __shared__ float red[2][kFoldThreads];
  fold_phase(st, fd, blockIdx.x, gridDim.x, threadIdx.x, red, BlockSync{}, x != nullptr);
}

// the blocks of stats_kernel<T, L> the card holds at once
template <typename T, class L>
inline int resident_blocks() {
  static int n = 0;
  if (n == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stats_kernel<T, L>, kThreads,
                                                      0) ||
        per_sm < 1)
      return 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n = per_sm * sms;
  }
  return n;
}

template <typename T, class L>
inline int launch_as(const void* x, const Stats& st, const Fold& fd, int m, cudaStream_t s,
                     const void* x2, int c1) {
  const long long items = x == nullptr
                              ? 0
                              : (long long)((m + kChunkRows - 1) / kChunkRows) * (st.c / L::kN);
  const long long want = std::max((items + kThreads - 1) / kThreads, (long long)fd.b * fd.groups);
  const int fit = resident_blocks<T, L>();
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long long>(std::max(want, 1LL), fit));
  const T* xp = static_cast<const T*>(x);
  const T* x2p = static_cast<const T*>(x2);
  Stats stv = st;
  Fold fdv = fd;
  int mv = m, c1v = x2 == nullptr ? st.c : c1;
  void* args[] = {&xp, &x2p, &stv, &fdv, &mv, &c1v};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stats_kernel<T, L>), dim3(grid), dim3(kThreads), args, 0,
      s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// chunks x 16-byte vectors at or above which a call reads 16 bytes a thread;
// below, bf16 pairs (four times the threads, more rows in flight each)
constexpr long long kWideItems = 32768;

// stats_kernel over x of element type T (c a multiple of 16 bytes' worth of
// T, x 16-byte aligned), or over the concat [x, x2] (x holding the first c1
// channels, also a multiple), and the fold into fd's (sc, sh); with x null
// the fold alone of the given partials. One cooperative launch: enough
// blocks for the vectors and for the fold's items, at most the resident
// ones. Returns cudaErrorInvalidValue for a width it does not take, else the
// launch's error.
template <typename T = __nv_bfloat16>
inline int launch(const void* x, const Stats& st, const Fold& fd, int m, cudaStream_t s,
                  const void* x2 = nullptr, int c1 = 0) {
  constexpr int kN = Vec<T>::kN;
  if (st.c % kN || st.c % fd.groups || (x2 != nullptr && (c1 % kN || c1 < kN || c1 >= st.c)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long wide = (long long)((m + kChunkRows - 1) / kChunkRows) * (st.c / kN);
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    if (wide < kWideItems) return launch_as<T, PairBf16>(x, st, fd, m, s, x2, c1);
  return launch_as<T, Vec<T>>(x, st, fd, m, s, x2, c1);
}

}  // namespace gn_stats
}  // namespace
