// Fused temporal-resnet frame convolutions (kernels A and B).
//
// Replaces svd_xtend_tpu/ops/pallas/temporal_resnet.py::_kernel_a and
// ::_kernel_b (via _tconv_core): the two (3, 1) frame convs of every
// TemporalResnetBlock, the GroupNorm normalise + SiLU of their input folded
// into a per-(sample, channel) affine, and their epilogues fused:
//
//   A: h   = conv1(silu(x*sc1 + sh1)) + b1 + temb[b, f]   (bf16 out), and
//          norm2's per-channel sum / sum of squares of the STORED bf16 h;
//   B: out = res + w * (conv2(silu(h*sc2 + sh2)) + b2),  w = 1 - alpha the
//          blend weight, an f32 scalar read from device memory (the JAX
//          package folds it into conv2's weights and bias instead; here the
//          packed weights stay the parameter's, made once per version).
//
// The frame conv is an implicit GEMM over (B, F, S, C) viewed as NHWC with
// N = B, H = F, W = S and a 3 x 1 filter: M = B*F*S output rows, N = C, K =
// 3C with k = tap*C + ci reading frame f + tap - 1, the frames outside
// [0, F) zero, i.e. the padding applied AFTER the activation, as the TPU
// kernel does (_tconv_core). The activation u = bf16(silu(x*sc + sh)) (the
// TPU kernel's rounding, _tconv_core:110) is a pass of its own
// (csrc/affine_silu.cuh, shared with conv3x3.cu), so each element is
// transformed once and not once per output column block.
//
// What bounds it on an H100: 2*M*3C*C FLOPs against ~2*M*C*2 bytes, 1.5 C
// FLOP/byte: tensor-core bound at the UNet's C = 320..1280 (0.0445 ms a
// launch at L0-L2), near the ridge at the VAE decoder's C = 128.
//
// Design: the shared Hopper mainloop of csrc/sm90_gemm.cuh (persistent
// blocks, a TMA producer warpgroup, two wgmma consumer warpgroups, BN = 128,
// 160 or 256, split-K with a fixed-order reduction, the output tile stored
// by TMA). A's K tile (128 rows x 64 channels of one frame tap) comes by
// TMA's im2col mode over u (sm90_gemm::FrameIm2colA): the walk runs across
// frames and samples, so tiles that straddle them (S = 40 at the 5x8 level,
// ragged last tiles, F = 1) need no special path, and the out-of-frame taps
// arrive as zeros. B is the (C, 3C) packed taps by a 2-D map. Kernel B's
// residual x is prefetched into the output tile by the producer.
//
// Norm2's statistics and fold (kernel A): after a consumer warpgroup has
// finished its 64 rows of the tile as bf16 in shared memory, each thread
// reads back one column pair down those rows, in row order, and writes f32
// sums and sums of squares per (sample, 64-row chunk) to the partials of
// csrc/gn_stats.cuh (a chunk straddles samples wherever F*S % 64 != 0, as
// at the 5x8 level's 560 rows a sample). After its last item the block's
// consumers meet every other block at a grid barrier (the persistent grid,
// one block an SM, launched cooperatively) and the consumers fold the
// statistics into norm2's (sc2, sh2) for kernel B (gn_stats::fold_phase),
// so the fold takes no launch of its own and the block is three launches
// (norm1's fold, A, B). The sums run in the order of the fold launch this
// replaces, whatever block runs them, so (sc2, sh2) keep their bits. Where the plan
// splits K the tile epilogue does not run: reduce_kernel stores h, and
// gn_stats::stats_kernel reads it back with the same per-chunk function and
// folds in the same order, so the statistics and (sc2, sh2) are the same
// bits as the unsplit path's for the same h.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, device time per launch in a
// CUDA graph, chip_smoke.py; PERF.md §6 has every shape):
//   - the first kernel (mma.sync m16n8k16, 128 x BN tiles of 64 x 32 warp
//     tiles, a 32-deep K step loaded synchronously with two __syncthreads a
//     step, the affine + SiLU recomputed in every thread's load path for
//     each of the C / BN column blocks, accumulator-layout global stores)
//     took conv_a / conv_b 0.674 / 0.667 ms at L0 (2, 14, 2560, 320), 0.492
//     / 0.513 at L1, 0.610 / 0.647 at L2, 0.269 / 0.273 at L3, ≈ 600 ms of
//     device time an exact video;
//   - this design, with the chunk statistics summed by one loop that looks
//     for sample boundaries on every row: 0.166-0.167 / 0.131 at L0, 127.5-
//     127.9 ms a video; with the boundary-free loop for chunks inside one
//     sample (the common case), 0.152 / 0.131, 124.2 ms a video;
//   - the statistics from device memory after the GEMM (gn_stats::
//     stats_kernel at every plan, as the split-K path does) in place of the
//     epilogue's read-back: conv_a 0.177 at L0 against 0.166 in the same
//     call, slower at every unsplit shape, 136.3 ms a video against 127.5:
//     taken out again;
//   - norm2's fold as a launch of its own between A and B (gn_stats::
//     fold_kernel, one block per (group, sample)): 0.0058 ms of device time
//     and 0.029-0.030 ms of host time a block, 44 launches a train step and
//     578 an exact video; in kernel A after its last tile (the same bits)
//     the block at L0 took 0.3222 ms of device time against 0.3206-0.3233
//     with the launch (scripts/bench_fold.py --tree, one call), and tickets
//     paid at every tile in place of the barrier made kernel A ~0.12 ms
//     slower at L0;
//   - not tried: the activation in the consumers where one N tile covers C
//     (C <= 256, the VAE decoder's lower levels). There the prologue pass is
//     0.26 ms of conv_a's 0.74-0.85 at (1, 8, 163840, 128); it would save
//     its write and re-read, about 3 ms of device time a video.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_silu.cuh"
#include "gn_stats.cuh"
#include "sm90_gemm.cuh"

// the tile widths BN the mainloop instantiates here (the plan picks one)
#define SVDX_TRESNET_TILE_N 128, 160, 256

namespace {

// the two consumer warpgroups' named barrier (ids 1 and 2 are each
// warpgroup's own)
struct ConsumersSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
  }
};

// Kernel A's epilogue: h = acc + b1 + temb[row / S] in f32, one cast; then
// the statistics of the stored h from the tile in shared memory, and their
// fold into norm2's (sc2, sh2).
struct ConvAEpi {
  static constexpr bool kPairs = true;
  static constexpr bool kStats = true;
  template <int BN>
  static constexpr int kOutCols = BN;
  __device__ static int out_col(int n0) { return n0; }
  const float* bias;           // (C) f32
  const __nv_bfloat16* temb;   // (B * F, C): row (b, f, s) adds temb[b * F + f]
  __nv_bfloat16* out;          // (M, C)
  gn_stats::Stats st;
  gn_stats::Fold fold_args;
  int c, s;
  struct Row {
    const __nv_bfloat16* t;  // the row's frame's time embedding
  };
  __device__ __forceinline__ Row row(int r) const { return {temb + (size_t)(r / s) * c}; }
  __device__ __forceinline__ float2 residual(int, int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ void finish(const Row& rw, int col, float2, float& v0,
                                         float& v1) const {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    const float2 t = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(rw.t + col)));
    v0 = v0 + b.x + t.x;
    v1 = v1 + b.y + t.y;
  }
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)row * c + col) = sm90::pack_bf16(v0, v1);
  }
  // a warpgroup's finished rows r0.. (kCols columns from n0, row-major in
  // shared memory): one column pair a thread
  template <int kCols>
  __device__ __forceinline__ void stats(const __nv_bfloat16* rows, int r0, int n0, int m,
                                        int t) const {
    if (r0 >= m) return;
    for (int p = t; p < kCols / 2; p += 128)
      if (n0 + 2 * p < c)
        st.chunk<gn_stats::PairBf16Tile>(rows + 2 * p, kCols, r0, m, n0 + 2 * p);
  }
  // after the last item, every consumer thread (256 a block), `red` free
  // shared memory: the fold of every block's statistics into norm2's (sc2,
  // sh2), a (sample, group) at a time per block
  __device__ __forceinline__ void fold(int t, float (*red)[gn_stats::kFoldThreads]) const {
    gn_stats::fold_phase(st, fold_args, blockIdx.x, gridDim.x, t, red, ConsumersSync{}, true);
  }
};

// Kernel B's epilogue: out = res + w * (acc + b2) in f32, one cast.
struct ConvBEpi {
  static constexpr bool kPairs = true;
  static constexpr bool kStats = false;
  template <int BN>
  static constexpr int kOutCols = BN;
  __device__ static int out_col(int n0) { return n0; }
  const float* bias;          // (C) f32
  const float* w;             // the blend weight, one f32
  const __nv_bfloat16* res;   // (M, C)
  __nv_bfloat16* out;         // (M, C)
  int c;
  struct Row {
    float w;
  };
  __device__ __forceinline__ Row row(int) const { return {__ldg(w)}; }
  __device__ __forceinline__ float2 residual(int r, int col) const {
    return __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(res + (size_t)r * c + col)));
  }
  __device__ __forceinline__ void finish(const Row& rw, int col, float2 r, float& v0,
                                         float& v1) const {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    v0 = fmaf(rw.w, v0 + b.x, r.x);
    v1 = fmaf(rw.w, v1 + b.y, r.y);
  }
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)row * c + col) = sm90::pack_bf16(v0, v1);
  }
};

}  // namespace

// One frame conv of the block on x (b, f, s, c) bf16, c % 64 == 0: the
// prologue u = bf16(silu(x*sc + sh)) (sc, sh: (b, c) f32; u: (b, f, s, c)
// bf16 scratch), then the GEMM with the packed taps wt (c, 3c) bf16 and bias
// (c) f32. first != 0: kernel A, extra = temb (b, f, c) bf16, psum / psq the
// (b, stats slots, c) f32 statistics, folded with scale2 / bias2 (c) f32
// (bf16 with affine_bf16) in
// `groups` groups into sc2 / sh2 (b, c) f32 (bar: the stream's barrier
// words), w null. Else kernel B,
// extra = the residual (b, f, s, c) bf16, w one f32, the norm2 arguments
// null. workspace: (k_slices, b*f*s, c) f32 when k_slices > 1, else null.
// All contiguous and 16-byte aligned (the wrapper checks). The plan
// (gemm_plan.tresnet_plan): tile width bn, the K split and `grid`
// persistent blocks. Returns the first CUDA error of the launches (0 on
// success), or cudaErrorInvalidValue for a plan this file does not take (a
// tensor map TMA refuses is found before anything runs).
extern "C" int svdx_temporal_resnet_conv(const void* x, const void* wt, const void* bias,
                                         const void* sc, const void* sh, void* u,
                                         const void* extra, const void* w, void* out,
                                         void* psum, void* psq, void* workspace,
                                         const void* scale2, const void* bias2, void* sc2,
                                         void* sh2, void* bar, int b, int f,
                                         int s, int c, int first, int bn, int k_slices, int grid,
                                         int groups, int affine_bf16, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m = b * f * s;
  if (first && (groups < 1 || c % groups)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map, c_map, r_map;
  int err = sm90_gemm::encode_im2col_map(&a_map, u, b, f, s, c, 1, sm90_gemm::kBM);
  if (err == 0) err = sm90_gemm::encode_matrix_map(&b_map, wt, 3 * c, c, bn);
  if (err == 0) err = sm90_gemm::encode_tile_map(&c_map, out, c, m, bn, 64);
  if (err == 0) err = sm90_gemm::encode_tile_map(&r_map, first ? out : extra, c, m, bn, 64);
  if (err != 0) return err;
  if ((err = affine_silu::launch(x, sc, sh, u, m, c, f * s, true, st))) return err;
  const sm90_gemm::Shape shape{m, c, 3 * c / sm90_gemm::kBK, k_slices,
                               static_cast<float*>(workspace), first ? 0 : 1};
  const sm90_gemm::FrameIm2colA aload{c / sm90_gemm::kBK, f, s};
  const auto* bp = static_cast<const float*>(bias);
  const auto* ep = static_cast<const __nv_bfloat16*>(extra);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (first) {
    const gn_stats::Stats stats{static_cast<float*>(psum), static_cast<float*>(psq), c, f * s,
                                gn_stats::slots(f * s)};
    const gn_stats::Fold fold =
        gn_stats::make_fold(bar, scale2, bias2, sc2, sh2, b, f * s, c, groups, eps,
                            affine_bf16);
    const ConvAEpi epi{bp, ep, op, stats, fold, c, s};
    err = sm90_gemm::launch_tile<sm90_gemm::FrameIm2colA, ConvAEpi, SVDX_TRESNET_TILE_N>(
        bn, a_map, b_map, c_map, r_map, shape, aload, epi, grid, st);
    // split K: reduce_kernel stored h; its statistics from device memory, folded
    if (err == 0 && k_slices > 1) err = gn_stats::launch(out, stats, fold, m, st);
    return err;
  }
  const ConvBEpi epi{bp, static_cast<const float*>(w), ep, op, c};
  return sm90_gemm::launch_tile<sm90_gemm::FrameIm2colA, ConvBEpi, SVDX_TRESNET_TILE_N>(
      bn, a_map, b_map, c_map, r_map, shape, aload, epi, grid, st);
}

// The prologue pass alone, u = bf16(silu(x*sc + sh)) over m rows of c
// channels (c % 8 == 0), for timing it apart from the GEMM.
extern "C" int svdx_affine_silu(const void* x, const void* sc, const void* sh, void* u, int m,
                                int c, int rows_per_sample, void* stream) {
  if (c % 8 || m < 1 || rows_per_sample < 1) return static_cast<int>(cudaErrorInvalidValue);
  return affine_silu::launch(x, sc, sh, u, m, c, rows_per_sample, true,
                             static_cast<cudaStream_t>(stream));
}
