// Residual GEGLU feed-forward on (T, C) tokens:
//
//   y = x + (h * gelu_tanh(g)) W2^T + b2,   [h | g] = LN(x) W1^T + b1
//
// Replaces svd_xtend_tpu/ops/pallas/geglu.py::_kernel (the norm3/ff and
// norm_in/ff_in feed-forwards of every spatial and temporal transformer
// block). Numerics as the TPU kernel: LayerNorm (eps 1e-5) statistics in
// f32, its output rounded to bf16; both products on bf16 operands with f32
// accumulation; the gate product u rounded to bf16 before the second
// product; tanh GELU; the residual added in bf16.
//
// Three launches, the LayerNorm'd tokens and u through device memory:
//   ln:    one warp per token row, two-pass f32 statistics -> xn (T, C) bf16;
//   gemm1: xn @ W1p^T on the shared TMA + wgmma mainloop (csrc/sm90_gemm.cuh)
//          with the value/gate pairing in its epilogue (GegluEpi). W1p is W1
//          packed by ops/kernels/geglu.py::pack_w1: its 128-row blocks hold 64
//          value rows followed by the matching 64 gate rows, so in an
//          m64n256 accumulator column j and j + 64 of a
//          block sit in the same thread, entries i and i + 32, and the
//          epilogue writes u = (h + b1v) * gelu(g + b1g) (T, 4C) bf16 with no
//          exchange between threads;
//   gemm2: u @ W2^T on the same mainloop, epilogue + b2 then + the bf16
//          residual x (ResidualEpi); where few tiles would leave SMs idle
//          (the 5x8 level's T), split over K with a fixed-order reduction.
// Tiles, K slices and grids are the plan's
// (ops/kernels/geglu.py::geglu_plan). Rows past T are zero-filled by TMA and
// not stored.
//
// Why through device memory, against the TPU kernel's design: keeping u on
// chip needs the (rows, C) f32 output accumulator of a token tile on chip
// for the whole inner loop; at C = 1280 a 64-row tile is 320 KB, so the
// first version of this kernel (one fused launch, accumulator in registers
// over 8 warps) took 32-row tiles and re-read every weight from L2 per tile:
// 0.877 ms at the L0 training site against 0.576 ms for the unfused bf16
// cuBLAS path, 3.27 ms per call at C >= 640 in a train step, and generate
// 6.95 s/video against 2.96 (H100 80GB HBM3, 700 W). Through memory, u
// costs 2*T*4C*2 bytes (184 MB at L0 training, ~55 us at 3.35 TB/s). The first
// GEMMs on that layout (mma.sync m16n8k16 from a 3-stage cp.async ring,
// 128 x BN x 32 tiles in 8 warps of 32-column warp tiles, one block per
// tile) took 0.606 ms at T 35840, C 320, about the unfused path's time; the
// 32-column warp tiles read shared memory at the rate that bounds them (see
// sm90_gemm.cuh), and gemm1's K = C = 320 gave each block 10 K tiles.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, device time per launch in a
// CUDA graph; scripts/bench_gemm_plans.py): T 71680, C 320 0.445 ms
// against the mma.sync GEMMs' 1.240 and the unfused bf16 module path's 0.995; T
// 4480, C 1280 0.334 against 0.781 and 0.423. At the 5x8 level's T (560,
// 1120) the module path is as fast or faster (0.067 / 0.116 against 0.085 /
// 0.116): there the two GEMMs' products are too few to fill the card.
//
// Not done: the LayerNorm inside gemm1's loads (it is a pass of 2*|x|
// bytes, about 14 us at T 35840); gemm1's GELU epilogue still runs while
// its block's tensor cores idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

// the tile widths the two GEMMs instantiate (the plan picks one each)
#define SVDX_GEGLU1_TILE_N 256
#define SVDX_GEGLU2_TILE_N 128, 160

namespace {

constexpr int kLnThreads = 256;  // 8 warps, one token row each
constexpr float kLnEps = 1e-5f;

// gelu with the tanh approximation; tanh(z) = 1 - 2 / (1 + e^(2z)) with z
// clamped to +-15 (where tanh is +-1 in f32), so e^(2z) stays finite
__device__ __forceinline__ float gelu_tanh(float g) {
  const float z = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  const float e = __expf(2.f * fminf(fmaxf(z, -15.f), 15.f));
  return 0.5f * g * (2.f - __fdividef(2.f, 1.f + e));
}

// ---------------------------------------------------------------- LayerNorm
__global__ void __launch_bounds__(kLnThreads)
ln_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ls,
          const float* __restrict__ lb, __nv_bfloat16* __restrict__ xn, int n_tok, int c) {
  const int row = blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_tok) return;
  const __nv_bfloat16* xr = x + (size_t)row * c;
  float sum = 0.f;
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i));
    sum += v.x + v.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / c;
  float sq = 0.f;
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i));
    sq += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / c + kLnEps);
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i));
    *reinterpret_cast<uint32_t*>(xn + (size_t)row * c + i) = sm90::pack_bf16(
        (v.x - mu) * rstd * ls[i] + lb[i], (v.y - mu) * rstd * ls[i + 1] + lb[i + 1]);
  }
}

// gemm1's epilogue on a tile of packed columns n0.. (n0 % 128 == 0): block q
// of the tile is value columns j = n0 / 2 + 64 q + c and gate columns
// inner + j for c < 64; its n8 blocks 16q + jb (value) and 16q + jb + 8
// (gate) hold the same j in this thread. Its output tile is the BN / 2 u
// columns n0 / 2.. of the tile's rows.
struct GegluEpi {
  static constexpr bool kPairs = false;
  static constexpr bool kStats = false;
  template <int BN>
  static constexpr int kOutCols = BN / 2;
  __device__ static int out_col(int n0) { return n0 / 2; }
  const float* b1;     // (2 * inner) f32, the unpacked order
  int inner;
  template <int BN>
  __device__ __forceinline__ void tile(float (&d)[BN / 2], int, int n0, int, int t,
                                       __nv_bfloat16* out, int tr0) const {
#pragma unroll
    for (int q = 0; q < BN / 128; ++q)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int c = 64 * q + 8 * jb + 2 * t;  // u column within the tile
        const float2 bh = __ldg(reinterpret_cast<const float2*>(b1 + n0 / 2 + c));
        const float2 bg = __ldg(reinterpret_cast<const float2*>(b1 + inner + n0 / 2 + c));
        const float* hv = d + 4 * (16 * q + jb);
        const float* gv = d + 4 * (16 * q + jb + 8);
        uint32_t* o = reinterpret_cast<uint32_t*>(out + tr0 * (BN / 2) + c);
        o[0] = sm90::pack_bf16((hv[0] + bh.x) * gelu_tanh(gv[0] + bg.x),
                               (hv[1] + bh.y) * gelu_tanh(gv[1] + bg.y));
        o[2 * BN] = sm90::pack_bf16((hv[2] + bh.x) * gelu_tanh(gv[2] + bg.x),  // 8 rows on
                                    (hv[3] + bh.y) * gelu_tanh(gv[3] + bg.y));
      }
  }
};

// gemm2's epilogue: out = x + bf16(acc + b2), the sum rounded once more
struct ResidualEpi {
  static constexpr bool kPairs = true;
  static constexpr bool kStats = false;
  template <int BN>
  static constexpr int kOutCols = BN;
  __device__ static int out_col(int n0) { return n0; }
  const float* b2;          // (C) f32
  const __nv_bfloat16* x;   // (T, C)
  __nv_bfloat16* out;       // (T, C)
  int c;
  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ float2 residual(int r, int col) const {
    return __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r * c + col)));
  }
  __device__ __forceinline__ void finish(const Row&, int col, float2 xf, float& v0,
                                         float& v1) const {
    const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + col));
    const float2 y = __bfloat1622float2(__floats2bfloat162_rn(v0 + b.x, v1 + b.y));
    v0 = xf.x + y.x;
    v1 = xf.y + y.y;
  }
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)row * c + col) = sm90::pack_bf16(v0, v1);
  }
};

}  // namespace

// x, out: (n_tok, c) bf16; xn: (n_tok, c) bf16 and u: (n_tok, 4c) bf16
// scratch; w1p: (8c, c) bf16 in pack_w1's order; w2: (c, 4c) bf16; ls, lb,
// b2: (c,) f32; b1: (8c,) f32 in W1's own order; workspace: (ks2, n_tok, c)
// f32 when ks2 > 1, else null; all contiguous, c % 64 == 0 (the wrapper
// checks). The plan (geglu_plan): gemm1 tile width bn1 on grid1 blocks;
// gemm2 tile width bn2, ks2 K slices on grid2 blocks.
// Returns the first CUDA error of the launches (0 on success), or
// cudaErrorInvalidValue for a plan this file does not take (a tensor map TMA
// refuses is found before anything launches).
extern "C" int svdx_ln_geglu_residual(const void* x, const void* ls, const void* lb,
                                      const void* w1p, const void* b1, const void* w2,
                                      const void* b2, void* xn, void* u, void* out,
                                      void* workspace, int n_tok, int c, int bn1, int grid1,
                                      int bn2, int ks2, int grid2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inner = 4 * c;
  CUtensorMap a1, b1m, c1, a2, b2m, c2, r2;
  int err = sm90_gemm::encode_matrix_map(&a1, xn, c, n_tok, sm90_gemm::kBM);
  if (err == 0) err = sm90_gemm::encode_matrix_map(&b1m, w1p, c, 2 * inner, bn1);
  if (err == 0) err = sm90_gemm::encode_tile_map(&c1, u, inner, n_tok, bn1 / 2, 64);
  if (err == 0) err = sm90_gemm::encode_matrix_map(&a2, u, inner, n_tok, sm90_gemm::kBM);
  if (err == 0) err = sm90_gemm::encode_matrix_map(&b2m, w2, inner, c, bn2);
  if (err == 0) err = sm90_gemm::encode_tile_map(&c2, out, c, n_tok, bn2, 64);
  if (err == 0) err = sm90_gemm::encode_tile_map(&r2, x, c, n_tok, bn2, 64);
  if (err != 0) return err;

  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  ln_kernel<<<(n_tok + 7) / 8, kLnThreads, 0, s>>>(xp, static_cast<const float*>(ls),
                                                  static_cast<const float*>(lb),
                                                  static_cast<__nv_bfloat16*>(xn), n_tok, c);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const sm90_gemm::Shape shape1{n_tok, 2 * inner, c / sm90_gemm::kBK, 1, nullptr, 0};
  const GegluEpi epi1{static_cast<const float*>(b1), inner};
  err = sm90_gemm::launch_tile<sm90_gemm::RowsA, GegluEpi, SVDX_GEGLU1_TILE_N>(
      bn1, a1, b1m, c1, c1, shape1, sm90_gemm::RowsA{}, epi1, grid1, s);
  if (err) return err;

  const sm90_gemm::Shape shape2{n_tok, c, inner / sm90_gemm::kBK, ks2,
                                static_cast<float*>(workspace), 1};
  const ResidualEpi epi2{static_cast<const float*>(b2), xp, static_cast<__nv_bfloat16*>(out), c};
  return sm90_gemm::launch_tile<sm90_gemm::RowsA, ResidualEpi, SVDX_GEGLU2_TILE_N>(
      bn2, a2, b2m, c2, r2, shape2, sm90_gemm::RowsA{}, epi2, grid2, s);
}
