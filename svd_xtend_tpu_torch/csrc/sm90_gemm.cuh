// The GEMM mainloop for Hopper (sm_90a) shared by the conv3x3 implicit GEMM
// (csrc/conv3x3.cu: forward and dU), the two GEMMs of the residual GEGLU
// (csrc/geglu.cu), the temporal resnet's frame convs (csrc/temporal_resnet.cu)
// and the upsample's four parity convs (csrc/upsample_conv.cu):
//
//   C (M x N, f32 accumulators) = A (M x K) . B (N x K)^T,   bf16 operands
//
// with both operands K-major (activation rows and nn.Linear / conv weight
// rows, K contiguous) and K in tiles of 64 = one 128-byte swizzle atom.
// What differs per kernel is a policy for where A's tiles come from and an
// epilogue for what becomes of C:
//   - A loader: RowsA, a box of (64 columns, BM rows) of a (rows, K) matrix
//     through a 2-D tensor map (GEGLU); Im2colA, the implicit GEMM's tile of
//     BM output pixels x 64 input channels of one tap, by TMA's im2col mode
//     over the NHWC input, so the "same" padding arrives as zeros: 3x3 taps
//     (conv3x3.cu) or, as FrameIm2colA, the 3 frame taps of the temporal
//     resnet's (3, 1) conv over (B, F, S, C) (temporal_resnet.cu).
//   - epilogue: a functor that turns this thread's accumulators of a tile
//     into bf16 (bias, shift, residual; GEGLU's value/gate product).
//
// A block is two consumer warpgroups (BM = 128 rows, 64 each) and one
// producer warpgroup, one block an SM. It is persistent: the blocks walk the items (N tile fastest,
// then M tile, then K slice) w = blockIdx.x, blockIdx.x + gridDim.x, ...,
// and the ring's stage counter runs on from one item into the next, so the
// producer fills the next item's stages while the consumers finish this
// one. The producer's first thread keeps a ring of kStages stages (A: BM x
// 64, B: BN x 64 bf16) filled by TMA, with full/empty mbarriers per stage.
// Each consumer warpgroup runs, per stage, four wgmma m64nBNk16 with both
// operands K-major in shared memory (its 64 rows of A, all BN rows of B),
// keeps one group in flight and releases the previous stage when it ends.
// The warpgroups hand registers over (setmaxnreg: producer 40, consumers
// 232).
//
// The epilogue goes through shared memory: each consumer warpgroup finishes
// its 64 rows of the tile in a row-major bf16 tile there and one of its
// threads stores them by TMA, asynchronously, while the warpgroup goes on
// to the next item. Where the epilogue adds a residual of the output's shape,
// the producer brings that tile by TMA into the same rows during the item's
// products, once the last store has read them. No consumer waits on device
// memory.
//
// Split-K: an item may cover a slice of the K tiles (slice s of S: tiles
// [s * kt / S, (s + 1) * kt / S)); then its consumers write f32 partial sums
// to a workspace (S, M, N), and reduce_kernel adds the slices in the fixed
// order 0..S-1 before the epilogue, so two runs give the same bits.
//
// Why wide tiles: a wgmma reads its A (64 x 16) and B (BN x 16) from shared
// memory, 128 bytes a clock an SM, while the tensor cores do 4,096 bf16
// FLOP a clock. Per k16 step a warpgroup reads 2,048 + 32 * BN bytes for
// 2,048 * BN FLOP, so BN = 64 is at the limit (1/32 byte per FLOP) and the
// old mma.sync kernels' 32- and 64-wide warp tiles were bound by shared
// memory reads; BN = 128-256 leaves a third to two fifths of it spare.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device time per launch in a
// CUDA graph; scripts/bench_gemm_plans.py times every plan the kernels take
// at the UNet's conv3x3 sites and GEGLU's shapes, and the variants named
// below were built from copies of these files in the same calls):
//   - the epilogue was the cost, not the mainloop: with the thread-per-pair
//     global stores of the accumulator layout the L0 forward (28x40x64,
//     320 -> 320, bias only) took 0.310 ms, 0.205 with no stores at all (644
//     TFLOP/s); staging the tile in shared memory for a TMA store, 0.261;
//     the residual by the producer's TMA (and each row's shift pointer once
//     per row), 0.217 (+ the residual 0.225, against 0.346 before);
//   - GEGLU at T 71680, C 320: 0.726 ms with the global stores, 0.445 now;
//   - reading everything before writing anything in the epilogue lost 3 %
//     (conv3x3) and 13 % (GEGLU) against one pass;
//   - two consumer warpgroups beat one (64-row tiles, two blocks an SM) at
//     every measured shape: the L0 forward 0.365 against 0.42-0.49 (global
//     stores), so one warpgroup was taken out again;
//   - clusters of two CTAs multicasting the B tile (half B's traffic from
//     L2) were within +-4 % of the same plan without them at every site (L0
//     0.372 against 0.365), and were taken out again; so was a tiled 4-D
//     load in place of the im2col one (the same bytes: within +-3 %);
//   - the K split now pays only where it fills the SMs (the 10x16 and 5x8
//     levels); ops/kernels/gemm_plan.py holds the model the plans follow.

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace sm90_gemm {

constexpr int kBK = 64;                 // K per stage: one 128-byte swizzle atom of bf16
constexpr int kC = 2;                   // consumer warpgroups, 64 rows each
constexpr int kBM = 64 * kC;            // rows per tile
constexpr int kSmemCap = 232448;        // the dynamic shared memory a block may use
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 40;

// ------------------------------------------------------------------ host --

typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeIm2col through the runtime's entry-point query, as
// sm90::encode_tiled_fn takes the tiled encoder (no -lcuda)
static inline EncodeIm2colFn encode_im2col_fn() {
  static EncodeIm2colFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeIm2col", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeIm2colFn>(p);
  }
  return fn;
}

// The im2col map of a stride-1 conv with 3 taps down and `taps_w` (3 or 1)
// across, "same" zero padding, over a contiguous bf16 NHWC tensor (n, h, w,
// c): a load at coordinates (c0, x - taps_w / 2, y - 1, n) with offsets
// (dx, dy), dx < taps_w, dy < 3, brings `pixels` output pixels, from (n, y, x)
// on in row-major pixel order (across rows and samples), each the 64
// channels c0.. of its source pixel (y + dy - 1, x + dx - taps_w / 2), zero
// where that falls outside the image or past the last sample. The bounding
// box's corners, (-taps_w / 2, -1) and (-taps_w / 2, -1) in (w, h) order,
// make the walk cover exactly the h x w output pixels of each sample. The
// 3x3 conv (conv3x3.cu) takes taps_w 3; the (3, 1) frame conv of the
// temporal resnet (temporal_resnet.cu), over (B, F, S, C) as n = B, h = F,
// w = S, takes 1. Returns 0, or cudaErrorInvalidValue where TMA does not take
// the geometry (c % 64, alignment) or the encoder refuses it.
static inline int encode_im2col_map(CUtensorMap* map, const void* base, int n, int h, int w,
                                    int c, int taps_w, int pixels) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || c % kBK != 0 || n < 1 || h < 1 ||
      w < 1 || pixels < 1 || pixels > 256 || (taps_w != 1 && taps_w != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeIm2colFn fn = encode_im2col_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const uint64_t pix = (uint64_t)c * 2;
  const cuuint64_t strides[3] = {pix, pix * (uint64_t)w, pix * (uint64_t)w * (uint64_t)h};
  const int lower[2] = {-(taps_w / 2), -1}, upper[2] = {-(taps_w / 2), -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, lower, upper, kBK, (cuuint32_t)pixels, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A (rows, k) row-major bf16 matrix as boxes of (64 columns, box_rows rows);
// rows past `rows` read as zero
static inline int encode_matrix_map(CUtensorMap* map, const void* base, int k, int rows,
                                    int box_rows) {
  return sm90::encode_rows_map(map, base, k, rows, 1, box_rows);
}

// A tile of the output (or of a residual of the output's shape): a (rows,
// cols) row-major bf16 matrix in boxes of (box_cols, box_rows) to or from a
// dense row-major tile in shared memory (no swizzle); a store clips the box
// at the matrix's edges, a load reads zeros past them
static inline int encode_tile_map(CUtensorMap* map, const void* base, int cols, int rows,
                                   int box_cols, int box_rows) {
  const uint64_t row_bytes = (uint64_t)cols * 2;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || row_bytes % 16 != 0 || box_cols % 8 != 0 ||
      box_cols < 8 || box_cols > 256 || box_rows < 1 || box_rows > 256 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn fn = sm90::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- device --

// TMA load of the box at (c0 column, c1 row) of a 2-D map into `dst`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store of the tile at `src` to the box at (c0 column, c1 row), in this
// thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's TMA stores have read their shared memory (kRead) or are done
template <bool kRead>
__device__ __forceinline__ void tma_store_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a consumer warpgroup's own barrier (named barrier 1 + wg, its 128 threads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}


// TMA, im2col mode: `pixels` (the map's) output pixels from coordinates
// (c0, x, y, n) at tap offsets (dx, dy) into `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map,
                                                uint64_t* bar, int c0, int x, int y, int n,
                                                uint16_t dx, uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(x), "r"(y),
      "r"(n), "h"(dx), "h"(dy)
      : "memory");
}

#define SVDX_G4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SVDX_G8(i) SVDX_G4(i), SVDX_G4(i + 4)
#define SVDX_G32(i) SVDX_G8(i), SVDX_G8(i + 8), SVDX_G8(i + 16), SVDX_G8(i + 24)
// one wgmma m64nNk16, A and B K-major from shared memory; the operands are
// the N / 2 accumulators, then desc_a (%IA), desc_b (%IB) and scale_d (%IS)
#define SVDX_WGMMA_SS(N, IA, IB, IS, REGS, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS   \
               "}, %" #IA ", %" #IB ", p, 1, 1, 0, 0;\n}\n"                        \
               : __VA_ARGS__                                                      \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// d (64 x kN f32) (+)= A (64 x 16) . B (kN x 16)^T, both K-major in shared
// memory (sm90::sw128_desc tiles); scale_d = 0 overwrites. kN is one of the
// tile widths the kernels instantiate.
template <int kN>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[kN / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  static_assert(kN == 8 || kN == 128 || kN == 160 || kN == 256,
                "no wgmma form for this tile width");
  if constexpr (kN == 8) {
    SVDX_WGMMA_SS(8, 4, 5, 6,
                  "%0,%1,%2,%3",
                  SVDX_G4(0));
  } else if constexpr (kN == 128) {
    SVDX_WGMMA_SS(128, 64, 65, 66,
                  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
                  "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,"
                  "%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
                  "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63",
                  SVDX_G32(0), SVDX_G32(32));
  } else if constexpr (kN == 160) {
    SVDX_WGMMA_SS(160, 80, 81, 82,
                  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
                  "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,"
                  "%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
                  "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"
                  "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79",
                  SVDX_G32(0), SVDX_G32(32), SVDX_G8(64), SVDX_G8(72));
  } else if constexpr (kN == 256) {
    SVDX_WGMMA_SS(256, 128, 129, 130,
                  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
                  "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,"
                  "%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
                  "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"
                  "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,"
                  "%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,"
                  "%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,"
                  "%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,"
                  "%123,%124,%125,%126,%127",
                  SVDX_G32(0), SVDX_G32(32), SVDX_G32(64), SVDX_G32(96));
  }
}

#undef SVDX_WGMMA_SS
#undef SVDX_G32
#undef SVDX_G8
#undef SVDX_G4

#define SVDX_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define SVDX_R8(i) SVDX_R4(i), SVDX_R4(i + 4)
#define SVDX_R32(i) SVDX_R8(i), SVDX_R8(i + 8), SVDX_R8(i + 16), SVDX_R8(i + 24)
// one wgmma m64nNk32 .s32.s8.s8, A and B K-major from shared memory (the
// integer forms take neither transposes nor operand negation); the operands
// are the N / 2 accumulators, then desc_a (%IA), desc_b (%IB), scale_d (%IS)
#define SVDX_WGMMA_S8(N, IA, IB, IS, REGS, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" REGS      \
               "}, %" #IA ", %" #IB ", p;\n}\n"                                   \
               : __VA_ARGS__                                                      \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// d (64 x kN s32) (+)= A (64 x 32 s8) . B (kN x 32 s8)^T, both K-major in
// shared memory; exact integer sums. kN is one of the int8 tile widths.
template <int kN>
__device__ __forceinline__ void wgmma_s8_n(int32_t (&d)[kN / 2], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  static_assert(kN == 128 || kN == 160 || kN == 256, "no int8 wgmma form for this tile width");
  if constexpr (kN == 128) {
    SVDX_WGMMA_S8(128, 64, 65, 66,
                  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
                  "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,"
                  "%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
                  "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63",
                  SVDX_R32(0), SVDX_R32(32));
  } else if constexpr (kN == 160) {
    SVDX_WGMMA_S8(160, 80, 81, 82,
                  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
                  "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,"
                  "%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
                  "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"
                  "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79",
                  SVDX_R32(0), SVDX_R32(32), SVDX_R8(64), SVDX_R8(72));
  } else if constexpr (kN == 256) {
    SVDX_WGMMA_S8(256, 128, 129, 130,
                  "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
                  "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,"
                  "%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,"
                  "%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,"
                  "%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,"
                  "%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,"
                  "%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,"
                  "%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,"
                  "%123,%124,%125,%126,%127",
                  SVDX_R32(0), SVDX_R32(32), SVDX_R32(64), SVDX_R32(96));
  }
}

#undef SVDX_WGMMA_S8
#undef SVDX_R32
#undef SVDX_R8
#undef SVDX_R4

// ------------------------------------------------------ operand types --

// What a stage holds and how the consumers multiply it. A stage is kKBytes
// of K for each of its BM + BN rows, one swizzle atom wide; the consumers
// run kKBytes / 32 wgmma steps on it, each 32 bytes further along K (a k16
// step of bf16, a k32 step of int8), so the ring, the barriers and the
// producer work in bytes and do not depend on the type.
//   - Bf16Ops (the default): 64 bf16 = 128 bytes, four k16 steps, f32
//     accumulators;
//   - S8Ops: 128 int8 codes = 128 bytes, four k32 steps, exact int32
//     accumulators (csrc/int8_gemm.cu).
// Both tiles are TMA's 128-byte swizzle (sm90::sw128_desc).
// An epilogue picks the type by a member `using Ops = ...` (OpsOf).
struct Bf16Ops {
  using Elem = __nv_bfloat16;
  using Acc = float;
  static constexpr int kKBytes = 128;
  static constexpr int kKElems = kBK;
  __device__ static __forceinline__ uint64_t desc(const void* p) { return sm90::sw128_desc(p); }
  template <int BN>
  __device__ static __forceinline__ void mma(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
    wgmma_ss_n<BN>(d, a, b, scale_d);
  }
};

struct S8Ops {
  using Elem = int8_t;
  using Acc = int32_t;
  static constexpr int kKBytes = 128;
  static constexpr int kKElems = 128;
  __device__ static __forceinline__ uint64_t desc(const void* p) { return sm90::sw128_desc(p); }
  template <int BN>
  __device__ static __forceinline__ void mma(int32_t (&d)[BN / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
    wgmma_s8_n<BN>(d, a, b, scale_d);
  }
};

template <class E, class = void>
struct OpsOf {
  using type = Bf16Ops;
};
template <class E>
struct OpsOf<E, std::void_t<typename E::Ops>> {
  using type = typename E::Ops;
};

// ---------------------------------------------------------- A loaders --

// A is a (rows, K) matrix: the item's rows m0.. of K tile kt
struct RowsA {
  struct Pos {
    int m0;
  };
  __device__ __forceinline__ Pos at(int m0) const { return {m0}; }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       Pos p, int kt) const {
    sm90::tma_load_3d(dst, map, bar, kt * kBK, p.m0, 0);
  }
};

// A is the implicit GEMM's im2col matrix of a stride-1 "same" conv with 3
// taps down and kTapsW across over NHWC (M = n*h*w output pixels, K =
// 3 * kTapsW * c, k = tap * c + channel, tap = kTapsW dy + dx): K tile kt is
// the 64 channels (kt % cblocks) * 64.. of tap kt / cblocks, one TMA im2col
// load (encode_im2col_map with taps_w = kTapsW) at the tap's offsets.
// Im2colA<3> is conv3x3's; Im2colA<1> (FrameIm2colA) the temporal resnet's
// (3, 1) frame conv over (B, F, S, C), whose frames outside [0, F) read as
// zeros.
template <int kTapsW>
struct Im2colA {
  int cblocks;  // c / 64
  int h, w;
  struct Pos {
    int x, y, n;  // the item's first output pixel, less the padding
  };
  __device__ __forceinline__ Pos at(int m0) const {
    const int hw = h * w, n = m0 / hw, r = m0 - n * hw, y = r / w;
    return {r - y * w - kTapsW / 2, y - 1, n};
  }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       Pos p, int kt) const {
    const int tap = kt / cblocks, cb = kt - tap * cblocks, dy = tap / kTapsW;
    tma_load_im2col(dst, map, bar, cb * kBK, p.x, p.y, p.n, (uint16_t)(tap - kTapsW * dy),
                    (uint16_t)dy);
  }
};
using FrameIm2colA = Im2colA<1>;

// Optional policy hooks, found by name (the loaders and epilogues above and
// in the kernels' sources have neither unless they say so):
//   - ALoad::b_batch(pos): the B map's third coordinate for the item at
//     `pos` (0 without it). The upsample's parity convs (upsample_conv.cu)
//     keep their four tap-summed weights as the batches of one 3-D map;
//   - Epi::store_tile(&c_map, rows, col, row0): stores a consumer
//     warpgroup's finished 64 rows in place of the 2-D TMA store of rows
//     row0.. at column col (in the thread's bulk group, committed). The
//     upsample's epilogue writes each parity's rows straight into the
//     interleaved 2x output;
//   - ALoad::load_b(dst, &b_map, bar, pos, kt, n0): loads K tile kt of the
//     B rows n0.. in place of the 3-D load at (kt * kKElems, n0,
//     b_batch(pos)). The int8 conv (int8_gemm.cu) reads its weights per tap;
//   - Epi::reduce(shape, stream): the split-K reduction and epilogue of an
//     epilogue without kPairs (the int8 GEMM's, over int32 partials).
template <class A, class = void>
struct HasBBatch : std::false_type {};
template <class A>
struct HasBBatch<A, std::void_t<decltype(&A::b_batch)>> : std::true_type {};
template <class E, class = void>
struct HasStoreTile : std::false_type {};
template <class E>
struct HasStoreTile<E, std::void_t<decltype(&E::store_tile)>> : std::true_type {};

template <class A, class = void>
struct HasLoadB : std::false_type {};
template <class A>
struct HasLoadB<A, std::void_t<decltype(&A::load_b)>> : std::true_type {};
template <class E, class = void>
struct HasReduce : std::false_type {};
template <class E>
struct HasReduce<E, std::void_t<decltype(&E::reduce)>> : std::true_type {};

template <class ALoad>
__device__ __forceinline__ int b_batch(const ALoad& aload, const typename ALoad::Pos& pos) {
  if constexpr (HasBBatch<ALoad>::value)
    return aload.b_batch(pos);
  else
    return 0;
}

// ------------------------------------------------------------ the kernel --

template <int BN, int kOutCols, class Ops = Bf16Ops>
struct Smem {
  static constexpr int kThreads = 128 * (kC + 1);
  static constexpr uint32_t kABytes = kBM * Ops::kKBytes, kBBytes = BN * Ops::kKBytes;
  // the budget less 1 KB of alignment slack and the barriers
  static constexpr int kOutBytes = kBM * kOutCols * 2;
  static constexpr int kBudget = kSmemCap - 1024 - 256 - kOutBytes;
  static constexpr int kFit = kBudget / static_cast<int>(kABytes + kBBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr uint32_t kConsumerRegs =
      (kThreads * kLaunchRegs - 128 * kProducerRegs) / (128 * kC) / 8 * 8;
  static_assert(kStages >= 2, "tile too large for a ring of two stages");
  // each BM * kKBytes = 16 KB: 1024-byte aligned
  typename Ops::Elem a[kStages][kBM * Ops::kKElems];
  typename Ops::Elem b[kStages][BN * Ops::kKElems];  // BN * kKBytes bytes, BN % 8 == 0
  __nv_bfloat16 out[kBM * kOutCols];     // the finished tile, row-major, for the TMA store
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t res_full[kC];   // a warpgroup's 64 rows of the residual are in `out`
  uint64_t out_free[kC];   // its last store has read them
};

// The shape of one launch and its split: M x N outputs, k_tiles K tiles of
// 64, k_slices K slices; items are (N tile, M tile, K slice) with the N tile
// fastest.
struct Shape {
  int m, n, k_tiles, k_slices;
  float* partial;  // (k_slices, m, n) f32 when k_slices > 1
  int residual;    // the epilogue adds a bf16 (m, n) residual (the kernel's r_map)
};

struct Item {
  int m0, n0, k0, k1, slice;
};

template <int BN>
__device__ __forceinline__ Item item_of(const Shape& s, int w) {
  const int n_tiles = (s.n + BN - 1) / BN, m_tiles = (s.m + kBM - 1) / kBM;
  const int nt = w % n_tiles, rest = w / n_tiles, mt = rest % m_tiles, ks = rest / m_tiles;
  return {mt * kBM, nt * BN, ks * s.k_tiles / s.k_slices, (ks + 1) * s.k_tiles / s.k_slices, ks};
}

template <int BN>
__host__ __device__ __forceinline__ int n_items(const Shape& s) {
  return ((s.n + BN - 1) / BN) * ((s.m + kBM - 1) / kBM) * s.k_slices;
}

// This thread's accumulator entries of an m64nBN tile as (row, column pair)
// stores: entries 4j, 4j + 1 are row r0 (= the warp's 16-row group + lane /
// 4), columns n0 + 8j + 2t and + 1; 4j + 2, 4j + 3 row r0 + 8 (sm90.cuh).
// Rows >= m and columns >= n are skipped (n is even).
template <int BN, class T, class F>
__device__ __forceinline__ void for_pairs(T (&d)[BN / 2], int r0, int n0, int m, int n, int t,
                                          F&& f) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= n) continue;
    if (r0 < m) f(r0, col, d[4 * j], d[4 * j + 1]);
    if (r0 + 8 < m) f(r0 + 8, col, d[4 * j + 2], d[4 * j + 3]);
  }
}

// Epilogues that act on column pairs have kPairs = true: row(r) gives what
// row r's outputs share (say, its sample's shift), finish(row context, col,
// residual pair, v0, v1) turns the f32 sums into the values to store, and
// residual(row, col) / store(row, col, v0, v1) read the residual from and
// write the values to device memory (the split-K reduce_kernel's way). In
// the tile's epilogue the residual, where there is one, is already in the
// block's output tile in shared memory: the producer brought it by TMA
// during the item's products. Each thread finishes its outputs there in
// place, as bf16, and one thread of the warpgroup stores its 64 rows by TMA
// (clipped at the matrix's edges), so no consumer waits on device memory.
// Others (GEGLU's value/gate product) write their tile by tile<BN>(...).
// kOutCols<BN> is the tile's width in output columns and out_col(n0) its
// first. An epilogue with kStats = true also reads its warpgroup's finished
// 64 rows back, stats<kOutCols>(rows, first row, n0, m, thread), once they
// are in shared memory (temporal_resnet.cu's kernel A: norm2's statistics of
// the stored bf16 values), and after its last item every consumer thread
// calls fold(thread, the output tile's memory as 2 x 256 floats), which may
// wait on every block of the grid (kernel A's fold of those statistics: the
// launch is then cooperative); the split-K path leaves both to its caller.
template <int BN, class Epi, class T>
__device__ __forceinline__ void epilogue(const Epi& epi, T (&d)[BN / 2], int r0, int n0,
                                         int m, int n, int t, __nv_bfloat16* tile, int tr0,
                                         bool residual) {
  if constexpr (Epi::kPairs) {
    const typename Epi::Row rows[2] = {epi.row(r0 < m ? r0 : 0),
                                       epi.row(r0 + 8 < m ? r0 + 8 : 0)};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 8 * j + 2 * t;
        uint32_t* p = reinterpret_cast<uint32_t*>(tile + (tr0 + 8 * h) * BN + 8 * j + 2 * t);
        float2 r = make_float2(0.f, 0.f);
        if (residual) {
          const uint32_t raw = *p;
          r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        }
        float& v0 = d[4 * j + 2 * h];
        float& v1 = d[4 * j + 2 * h + 1];
        if (col < n) epi.finish(rows[h], col, r, v0, v1);
        *p = sm90::pack_bf16(v0, v1);
      }
  } else {
    epi.template tile<BN>(d, r0, n0, m, t, tile, tr0);
  }
}

template <int BN, class ALoad, class Epi>
__global__ void __launch_bounds__(Smem<BN, Epi::template kOutCols<BN>>::kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
            const __grid_constant__ CUtensorMap c_map, const __grid_constant__ CUtensorMap r_map,
            const Shape shape, const ALoad aload, const Epi epi) {
  using Ops = typename OpsOf<Epi>::type;
  using Acc = typename Ops::Acc;
  using Sm = Smem<BN, Epi::template kOutCols<BN>, Ops>;
  constexpr int kStages = Sm::kStages;
  extern __shared__ char smem_raw[];
  Sm& sm = sm90::aligned_smem<Sm>(smem_raw);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int items = n_items<BN>(shape);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * kC);  // one arrival per consumer warp
    }
    for (int h = 0; h < kC; ++h) {
      sm90::mbar_init(&sm.res_full[h], 1);
      sm90::mbar_init(&sm.out_free[h], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kC) {  // producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      sm90::prefetch_map(&a_map);
      sm90::prefetch_map(&b_map);
      const bool residual = shape.residual && shape.k_slices == 1;
      constexpr int kRows = 64 * Epi::template kOutCols<BN>;  // a warpgroup's tile rows
      int it = 0;
      for (int w = blockIdx.x, ii = 0; w < items; w += gridDim.x, ++ii) {
        const Item item = item_of<BN>(shape, w);
        const typename ALoad::Pos pos = aload.at(item.m0);
        // the residual tile once the item's first stages are on their way
        // and the consumers are into its products
        const int res_at = item.k0 + min(item.k1 - item.k0, kStages) - 1;
        for (int kt = item.k0; kt < item.k1; ++kt, ++it) {
          const int st = it % kStages;
          sm90::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&sm.full[st], Sm::kABytes + Sm::kBBytes);
          aload.load(sm.a[st], &a_map, &sm.full[st], pos, kt);
          if constexpr (HasLoadB<ALoad>::value)
            aload.load_b(sm.b[st], &b_map, &sm.full[st], pos, kt, item.n0);
          else
            sm90::tma_load_3d(sm.b[st], &b_map, &sm.full[st], kt * Ops::kKElems, item.n0,
                              b_batch(aload, pos));
          if (residual && kt == res_at) {
            for (int h = 0; h < kC; ++h) {
              sm90::mbar_wait(&sm.out_free[h], (ii & 1) ^ 1);
              sm90::mbar_arrive_expect_tx(&sm.res_full[h], kRows * 2);
              tma_load_2d(sm.out + h * kRows, &r_map, &sm.res_full[h], Epi::out_col(item.n0),
                          item.m0 + 64 * h);
            }
          }
        }
      }
    }
  } else {  // consumers
    sm90::setmaxnreg_inc<Sm::kConsumerRegs>();
    const int t = lane & 3;
    const bool storer = threadIdx.x % 128 == 0;  // issues its warpgroup's TMA stores
    // after the products that read stage st: one arrival per warp
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[st]);
    };
    const bool residual = shape.residual && shape.k_slices == 1;
    Acc acc[BN / 2];
    int it = 0;
    for (int w = blockIdx.x, ii = 0; w < items; w += gridDim.x, ++ii) {
      const Item item = item_of<BN>(shape, w);
      if constexpr (Epi::kStats) {
        // the item's first product overwrites them; defined here, they are
        // dead between items, which leaves the fold after the last item its
        // registers (at BN = 256 it spilled)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
      }
      for (int kt = item.k0; kt < item.k1; ++kt, ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&sm.full[st], (it / kStages) & 1);
        const uint64_t ad = Ops::desc(sm.a[st] + wg * 64 * Ops::kKElems);
        const uint64_t bd = Ops::desc(sm.b[st]);
        sm90::wgmma_fence();
        sm90::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < Ops::kKBytes / 32; ++kk)
          Ops::template mma<BN>(acc, sm90::kmajor_slice(ad, kk), sm90::kmajor_slice(bd, kk),
                                kt > item.k0 || kk > 0);
        sm90::wgmma_commit();
        // the last item's store has read its rows by now: the producer may
        // bring this item's residual into them
        if (residual && storer && kt == item.k0 && ii > 0) {
          tma_store_wait<true>();
          sm90::mbar_arrive(&sm.out_free[wg]);
        }
        __syncwarp();
        sm90::wgmma_wait<1>();  // the stage before this one is read
        sm90::fence_regs(acc);
        if (kt > item.k0) release((it - 1) % kStages);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      release((it - 1) % kStages);

      const int tr0 = wg * 64 + 16 * warp + (lane >> 2);  // this thread's first tile row
      const int r0 = item.m0 + tr0;
      if (shape.k_slices > 1) {
        // f32 partials, or the int8 GEMM's exact int32 ones, in the same words
        Acc* part = reinterpret_cast<Acc*>(shape.partial) + (size_t)item.slice * shape.m * shape.n;
        for_pairs<BN>(acc, r0, item.n0, shape.m, shape.n, t,
                      [&](int row, int col, Acc& v0, Acc& v1) {
                        Acc* p = part + (size_t)row * shape.n + col;
                        if constexpr (std::is_same_v<Acc, float>)
                          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
                        else
                          *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
                      });
      } else {
        // each warpgroup stores its own 64 rows, so neither waits for the
        // other's epilogue; first its last store must have read them
        __nv_bfloat16* rows = sm.out + wg * 64 * Epi::template kOutCols<BN>;
        if (residual) {
          sm90::mbar_wait(&sm.res_full[wg], ii & 1);
        } else {
          if (storer) tma_store_wait<true>();
          warpgroup_sync(wg);
        }
        epilogue<BN>(epi, acc, r0, item.n0, shape.m, shape.n, t, rows, tr0 - wg * 64, residual);
        sm90::fence_proxy_async();  // the tile's writes, visible to the TMA store
        warpgroup_sync(wg);
        if (storer) {
          if constexpr (HasStoreTile<Epi>::value)
            epi.store_tile(&c_map, rows, Epi::out_col(item.n0), item.m0 + wg * 64);
          else
            tma_store_2d(&c_map, rows, Epi::out_col(item.n0), item.m0 + wg * 64);
        }
        // statistics of the stored values, read back from the finished rows
        // (the next item's epilogue writes them only after its
        // warpgroup_sync, so after every thread is done here)
        if constexpr (Epi::kStats)
          epi.template stats<Epi::template kOutCols<BN>>(rows, item.m0 + wg * 64, item.n0,
                                                         shape.m, threadIdx.x % 128);
      }
    }
    if (storer) tma_store_wait<false>();
    // the stores have read the output tile: its first 2 KB are the fold's
    if constexpr (Epi::kStats)
      if (shape.k_slices == 1)
        epi.fold(threadIdx.x, reinterpret_cast<float(*)[256]>(sm.out));
  }
}

// the split-K sums: out = epi(sum over slices 0..S-1 of the partials), one
// column pair a thread
template <class Epi>
__global__ void __launch_bounds__(256) reduce_kernel(const Shape shape, const Epi epi) {
  const long long pairs = (long long)shape.m * shape.n / 2;
  const size_t plane = (size_t)shape.m * shape.n;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * 256) {
    const size_t e = (size_t)i * 2;
    float2 v = *reinterpret_cast<const float2*>(shape.partial + e);
    for (int s = 1; s < shape.k_slices; ++s) {
      const float2 p = *reinterpret_cast<const float2*>(shape.partial + s * plane + e);
      v.x += p.x;
      v.y += p.y;
    }
    const int row = static_cast<int>(e / shape.n), col = static_cast<int>(e % shape.n);
    epi.finish(epi.row(row), col, epi.residual(row, col), v.x, v.y);
    epi.store(row, col, v.x, v.y);
  }
}

static inline int sm_count() {
  static const int n_sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return n_sms;
}

// One launch of the BN-wide kernel on `grid` persistent blocks (the plan's:
// at most the items, and at most one an SM), then the split-K reduction
// when shape.k_slices > 1. Returns the first CUDA error.
template <int BN, class ALoad, class Epi>
int launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const CUtensorMap& c_map,
           const CUtensorMap& r_map, const Shape& shape, const ALoad& aload, const Epi& epi,
           int grid, cudaStream_t stream) {
  using Sm = Smem<BN, Epi::template kOutCols<BN>, typename OpsOf<Epi>::type>;
  // an epilogue that reads its finished rows back (kStats) cannot share them
  // with a residual the producer brings in
  if (grid < 1 || grid > n_items<BN>(shape) || grid > sm_count() ||
      shape.k_slices < 1 || shape.k_slices > shape.k_tiles ||
      (shape.k_slices > 1 && shape.partial == nullptr) || (Epi::kStats && shape.residual))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = sm90::smem_bytes<Sm>();
  const auto kernel = gemm_kernel<BN, ALoad, Epi>;
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  if constexpr (Epi::kStats) {
    // its fold waits for every block: all of them resident at once
    CUtensorMap maps[4] = {a_map, b_map, c_map, r_map};
    Shape sh = shape;
    ALoad al = aload;
    Epi ep = epi;
    void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &sh, &al, &ep};
    err = static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                       dim3(grid), dim3(Sm::kThreads), args,
                                                       smem, stream));
    if (err) return err;
  } else {
    kernel<<<grid, Sm::kThreads, smem, stream>>>(a_map, b_map, c_map, r_map, shape, aload, epi);
  }
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (shape.k_slices > 1) {
    if constexpr (Epi::kPairs) {
      const long long pairs = (long long)shape.m * shape.n / 2;
      const long long want = (pairs + 255) / 256, cap = 16LL * sm_count();
      reduce_kernel<<<static_cast<int>(want < cap ? want : cap), 256, 0, stream>>>(shape, epi);
      err = static_cast<int>(cudaGetLastError());
    } else if constexpr (HasReduce<Epi>::value) {
      err = epi.reduce(shape, stream);
    } else {
      err = static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return err;
}

// launch<BN> for the tile width bn of a plan, BN one of kBNs
template <class ALoad, class Epi, int BN0, int... kBNs>
int launch_tile(int bn, const CUtensorMap& a_map, const CUtensorMap& b_map,
                const CUtensorMap& c_map, const CUtensorMap& r_map, const Shape& shape,
                const ALoad& aload, const Epi& epi, int grid, cudaStream_t stream) {
  if (bn == BN0)
    return launch<BN0>(a_map, b_map, c_map, r_map, shape, aload, epi, grid, stream);
  if constexpr (sizeof...(kBNs) > 0)
    return launch_tile<ALoad, Epi, kBNs...>(bn, a_map, b_map, c_map, r_map, shape, aload, epi,
                                            grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90_gemm
