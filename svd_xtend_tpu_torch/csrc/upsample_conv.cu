// Nearest 2x upsample followed by a 3x3 SAME convolution, on NHWC bf16, as
// four 2x2 convolutions at the input resolution (the parity decomposition):
//
//   y[n, 2i+di, 2j+dj, :] = bf16(bf16(conv2x2_{di,dj}(x)[n, i, j, :]) + b)
//
// where conv2x2_{di,dj} takes the taps {i-1+di, i+di} x {j-1+dj, j+dj} of x
// (zero outside the image) with the tap-summed kernel of parity (di, dj):
// rows K[0], K[1]+K[2] for di = 0 and K[0]+K[1], K[2] for di = 1, columns
// the same (ops/upsample.py::tap_sums). No 4x intermediate is made, and the
// products are 16 taps an output pixel instead of the 3x3 conv's 9 at 4x the
// pixels (4/9 of the FLOPs).
//
// Counterpart of svd_xtend_tpu/ops/upsample.py::upsample2x_conv3x3, which
// the JAX package's Upsample2D runs by default (SVDX_FUSED_UPSAMPLE "1"):
// XLA code there (four lax convs, a stack and a reshape), not a Pallas
// kernel. Numerics as that function: f32 accumulation of bf16 products, the
// conv's output rounded to bf16, then the bf16 bias added and rounded again.
//
// What bounds it on an H100: 32*M*Ci*Co FLOPs (M = N*H*W input pixels)
// against 2*M*Ci + 8*M*Co bytes, 32*Ci*Co / (2*Ci + 8*Co) FLOP/byte: 819
// at Ci = Co = 256 (the VAE decoder's last upsampler), 3277-4096 at 512-1280.
// Tensor-core bound at every UNet and VAE site.
//
// Design: the four parities are one launch on the shared mainloop of
// csrc/sm90_gemm.cuh, each an implicit GEMM at the input resolution (M =
// N*H*W rows, N = Co, K = 4*Ci, k = (2a + b)*Ci + ci for the 2x2 tap (a, b)).
// The launch's rows are the four parities' one after the other, each padded
// to whole 128-row tiles (m_pad), so a tile never spans two parities and
// the work item carries its parity in its row.
//   - A: ParityIm2colA reads the existing 3x3 im2col map (the SAME padding
//     and the pixels past the last sample arrive as zeros): parity (di, dj)
//     takes the 4 of the 9 tap offsets in {di, di+1} x {dj, dj+1} (offsets
//     -1..1 shifted by 1). No new tensor map, no padded copy of x.
//   - B: the tap-summed weights (4, Co, 4*Ci), K-major, as the batches of
//     one 3-D map; the parity is the batch coordinate (the mainloop's
//     b_batch hook).
//   - Epilogue (UpsampleEpi): rounds the sums to bf16, adds the bias, and
//     stores each consumer warpgroup's 64 finished rows straight into their
//     output pixels (n, 2i+di, 2j+dj) by one 5-D TMA store over the output
//     viewed as (N*H, 2, W, 2, Co) (the mainloop's store_tile hook): 64
//     rows are 64/W whole image rows where W divides 64, a 64-pixel run of
//     one row where W is a multiple of 64. Any other W (5, 9, 40, 72 at
//     the 320- and 576-wide resolutions) takes 64/g stores of g pixels, g =
//     gcd(W, 64): a run of g pixels never crosses an image row, since rows
//     start at multiples of W and every store at a multiple of g. Rows
//     past the last sample are clipped by the map. There is no interleave
//     pass.
//   - Where few tiles would leave SMs idle (the UNet's 5x8 level) the plan
//     splits K, as conv3x3's does: the f32 partials are summed in a fixed
//     order by the mainloop's reduce kernel, whose store() writes each
//     pair to its output pixel.
// The plan (tile width, K slices, grid) is ops/kernels/upsample_conv.py's
// upsample_plan, a pure function of the shape; this file takes it and
// refuses what it does not instantiate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

// the tile widths the upsample instantiates (the plan picks one)
#define SVDX_UPSAMPLE_TILE_N 128, 160, 256

namespace {

using sm90_gemm::kBK;

// A of parity p = 2*di + dj: the 3x3 im2col map's tap offsets (dj + b,
// di + a) for the K tiles of 2x2 tap (a, b)
struct ParityIm2colA {
  int cblocks;  // ci / 64
  int h, w;
  int m_pad;    // rows of one parity's GEMM: N*H*W up to whole 128-row tiles
  struct Pos {
    int x, y, n, parity;  // the item's first pixel, less the padding
  };
  __device__ __forceinline__ Pos at(int m0) const {
    const int parity = m0 / m_pad, local = m0 - parity * m_pad;
    const int hw = h * w, n = local / hw, r = local - n * hw, y = r / w;
    return {r - y * w - 1, y - 1, n, parity};
  }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       Pos p, int kt) const {
    const int tap = kt / cblocks, cb = kt - tap * cblocks;
    sm90_gemm::tma_load_im2col(dst, map, bar, cb * kBK, p.x, p.y, p.n,
                               (uint16_t)((p.parity & 1) + (tap & 1)),
                               (uint16_t)((p.parity >> 1) + (tap >> 1)));
  }
  __device__ __forceinline__ int b_batch(Pos p) const { return p.parity; }
};

// TMA store of the tile at `src` to the box at (c0, c1, c2, c3, c4) of a
// 5-D map, in this thread's bulk group
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16(sum) + bias, rounded again by the store; rows are the launch's
// (parity, padded pixel) rows
struct UpsampleEpi {
  static constexpr bool kPairs = true;
  static constexpr bool kStats = false;
  template <int BN>
  static constexpr int kOutCols = BN;
  __device__ static int out_col(int n0) { return n0; }
  const float* bias;   // (Co) f32 holding the bf16 bias
  __nv_bfloat16* out;  // (N, 2H, 2W, Co)
  int co, w, m, m_pad;  // m = N*H*W
  int run;             // pixels a TMA store writes: W where W divides 64, else gcd(W, 64)
  int row_bytes;       // a row of the finished tile in shared memory (the tile width x 2)
  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ float2 residual(int, int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ void finish(const Row&, int col, float2, float& v0,
                                         float& v1) const {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
    v0 = round_bf16(v0) + b.x;
    v1 = round_bf16(v1) + b.y;
  }
  // the split-K reduce's store of one column pair of launch row `row`
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    const int parity = row / m_pad, local = row - parity * m_pad;
    if (local >= m) return;
    const int r = local / w, j = local - r * w;  // r = n*H + i
    const size_t o =
        ((size_t)(2 * r + (parity >> 1)) * 2 * w + 2 * j + (parity & 1)) * co + col;
    *reinterpret_cast<uint32_t*>(out + o) = sm90::pack_bf16(v0, v1);
  }
  // a consumer warpgroup's 64 finished rows from launch row row0: boxes of
  // the (N*H, 2, W, 2, Co) map at (col, dj, j, di, r), one where W divides
  // 64 (its box is 64/W image rows), else one per run of `run` pixels
  __device__ __forceinline__ void store_tile(const CUtensorMap* map, const void* rows, int col,
                                             int row0) const {
    const int parity = row0 / m_pad, local = row0 - parity * m_pad;
    const int step = run < w ? run : 64;
    for (int p = 0; p < 64 && local + p < m; p += step) {
      const int r = (local + p) / w, j = local + p - r * w;
      tma_store_5d(map, static_cast<const char*>(rows) + p * row_bytes, col, parity & 1, j,
                   parity >> 1, r);
    }
  }
};

// The pixels one store of the epilogue writes: W where W divides 64 (a box
// of 64/W image rows), else gcd(W, 64) (a box within one image row)
static inline int store_run(int w) { return 64 % w == 0 ? w : (w & -w) < 64 ? (w & -w) : 64; }

// The output (n, 2h, 2w, co) bf16 as (co, dj 2, w, di 2, n*h) for the
// epilogue's stores: boxes of (bn, 1, run, 1, 64 / w or 1) pixels. A store
// of a box that does not start the tile starts `run` rows of bn columns in,
// which TMA takes only at 128-byte alignment. 0 or cudaErrorInvalidValue
static inline int encode_parity_map(CUtensorMap* map, void* out, int nh, int w, int co, int bn) {
  const int run = store_run(w);
  const uint64_t pix = (uint64_t)co * 2;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || pix % 16 != 0 || bn % 8 != 0 || bn > 256 ||
      (run < 64 && run < w && run * bn * 2 % 128 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn fn = sm90::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[5] = {(cuuint64_t)co, 2, (cuuint64_t)w, 2, (cuuint64_t)nh};
  const cuuint64_t strides[4] = {pix, 2 * pix, 2 * pix * (uint64_t)w, 4 * pix * (uint64_t)w};
  const cuuint32_t box[5] = {(cuuint32_t)bn, 1, (cuuint32_t)run, 1,
                             (cuuint32_t)(run == w ? 64 / w : 1)};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, out, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (n, h, w, ci) bf16; wt: the tap-summed weights (4, co, 2, 2, ci) bf16,
// parity p = 2 di + dj first; bias: (co,) f32 (bf16 values); out: (n, 2h,
// 2w, co) bf16; workspace: (k_slices, 4 * m_pad, co) f32 when k_slices > 1,
// else null, m_pad = n*h*w rounded up to 128. All contiguous; ci % 64 == 0
// and co % 8 == 0 (the wrapper checks). The plan (upsample_plan): tile
// width bn, the K split and `grid` persistent blocks; where W neither
// divides 64 nor is a multiple of it, run * bn * 2 a multiple of 128 (no
// 160-wide tile at an odd W). Returns the first CUDA error of the launches
// (0 on success), or cudaErrorInvalidValue for a plan or geometry this file
// does not take.
extern "C" int svdx_upsample_conv(const void* x, const void* wt, const void* bias, void* out,
                                  void* workspace, int n, int h, int w, int ci, int co, int bn,
                                  int k_slices, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * h * w;
  const int m_pad = (m + sm90_gemm::kBM - 1) / sm90_gemm::kBM * sm90_gemm::kBM;
  CUtensorMap a_map, b_map, c_map;
  if (ci % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = sm90_gemm::encode_im2col_map(&a_map, x, n, h, w, ci, 3, sm90_gemm::kBM);
  if (err == 0) err = sm90::encode_rows_map(&b_map, wt, 4 * ci, co, 4, bn);
  if (err == 0) err = encode_parity_map(&c_map, out, n * h, w, co, bn);
  if (err != 0) return err;
  const sm90_gemm::Shape shape{4 * m_pad, co, 4 * ci / kBK, k_slices,
                               static_cast<float*>(workspace), 0};
  const ParityIm2colA aload{ci / kBK, h, w, m_pad};
  const UpsampleEpi epi{static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), co,
                        w, m, m_pad, store_run(w), 2 * bn};
  return sm90_gemm::launch_tile<ParityIm2colA, UpsampleEpi, SVDX_UPSAMPLE_TILE_N>(
      bn, a_map, b_map, c_map, c_map, shape, aload, epi, grid, s);
}
