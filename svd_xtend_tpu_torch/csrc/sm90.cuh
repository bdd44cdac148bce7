// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels:
// the host-side encoding of a TMA tensor map over a packed (B, S, H*64) bf16
// tensor, mbarrier wait/arrive, the TMA load, the wgmma shared-memory
// descriptors of a 128-byte-swizzled tile and the m64n64k16 bf16 -> f32
// wgmma forms (A in registers, or both operands in shared memory).
//
// The tile every helper describes: TMA loads a box of (64 columns = one
// 64-wide head, R rows) with CU_TENSOR_MAP_SWIZZLE_128B into shared memory
// aligned to 1024 bytes, so row r sits at r * 128 bytes with its eight
// 16-byte chunks permuted by chunk ^ (r % 8). wgmma reads that tile in both
// orientations:
//   - K-major (the tile's columns are the product's reduction dimension,
//     e.g. K in Q K^T): rows are the M or N index, 8-row groups 1024 bytes
//     apart (SBO), and the k-th 16-column slice starts k * 32 bytes in;
//   - MN-major (the tile's rows are the reduction dimension, e.g. K in
//     dS K, with the transpose bit set): 64 columns = one swizzle atom wide,
//     8-row groups of the reduction dimension 1024 bytes apart (SBO), and
//     the k-th 16-row slice starts k * 2048 bytes in.
// A wgmma operand in registers has the layout of mma.sync's m16n8k16 A
// fragment, warp w of the warpgroup holding rows 16w..16w+15; an m64nN f32
// accumulator holds, in d[i], row 16w + lane/4 + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2, so two neighbouring n8 blocks
// of an accumulator re-pack in registers into one k16 A fragment.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ------------------------------------------------------------------ host --

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; take it through the
// runtime's entry-point query so the shared library needs no -lcuda.
static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 (batch, rows, n_cols) tensor whose box is
// (64 columns, box_rows rows, 1): one head's rows of one sample. Rows past
// `rows` read as zero within each sample, so a ragged tail never reads the
// next sample. Returns 0, or cudaErrorInvalidValue when the geometry is one
// TMA does not take (base or row stride not a multiple of 16 bytes, a box
// of more than 256 rows) or the encoder refuses it.
static inline int encode_rows_map(CUtensorMap* map, const void* base, int n_cols, int rows,
                                  int batch, int box_rows) {
  const uint64_t row_bytes = (uint64_t)n_cols * 2;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || row_bytes % 16 != 0 || n_cols < 64 ||
      rows < 1 || batch < 1 || box_rows < 1 || box_rows > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {(cuuint64_t)n_cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * (uint64_t)rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- device --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The kernel's shared-memory struct at the first 1024-byte boundary of the
// dynamic shared memory `raw`, as the 128-byte swizzle pattern needs; the
// launch asks for smem_bytes<T>(), 1 KB more than the struct.
template <typename T>
__device__ __forceinline__ T& aligned_smem(char* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<T*>(raw + pad);
}

template <typename T>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(T)) + 1024;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed; a wait that never
// completes (a fault in a kernel's barrier protocol) traps after 2^26 polls,
// so the launch fails instead of hanging the card.
// Why a count of polls and not of time: polls advance only while the
// waiting warp runs; when the card time-slices or preempts the context,
// every warp of the block stops with it. What a wait waits for is in the
// same block (its producer or consumer warps) or is the TMA unit serving
// it, so a wait that is only slow lasts one tile's work or load:
// microseconds. 2^26 polls, each at least a shared-memory round trip
// (~30 cycles), take about a second of the warp's own running time. A bound
// on %globaltimer instead cost the dK/dV kernel 3-6 % (NVIDIA H100 80GB
// HBM3, 700.00 W; chip_smoke.py from copies of the tree that differed only
// here), with the same registers and no spills.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// generic-proxy shared-memory writes -> visible to TMA / wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// TMA: the box at (c0 column, c1 row, c2 sample) into `dst`, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <uint32_t kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <uint32_t kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Descriptor of a 128-byte-swizzled tile at `smem` (see the top of the
// file): layout type 1 (128B swizzle) in bits 62-63, SBO (bits 32-45) 1024
// bytes between 8-row groups. The LBO (bits 16-29) is not read for a
// K-major operand, nor for an MN-major one no wider than one 64-element
// swizzle atom, as every tile here is; it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// the k-th k16 slice of a tile: K-major +32 bytes, MN-major +16 rows
__device__ __forceinline__ uint64_t kmajor_slice(uint64_t desc, int k) {
  return desc + uint64_t((k * 32) >> 4);
}
__device__ __forceinline__ uint64_t mnmajor_slice(uint64_t desc, int k) {
  return desc + uint64_t((k * 2048) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it (issue ... wait)
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SVDX_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SVDX_D32 SVDX_D8(0), SVDX_D8(8), SVDX_D8(16), SVDX_D8(24)

// d (64 x 64 f32) (+)= A (64 x 16 bf16, registers) . B (16 x 64 bf16, shared
// memory descriptor); kTransB = 1 reads B MN-major. scale_d = 0 overwrites.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : SVDX_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(kTransB));
}

// d (64 x 64 f32) (+)= A (64 x 16, shared memory) . B (16 x 64, shared memory)
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : SVDX_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

#undef SVDX_D32
#undef SVDX_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A operand (64 rows x 64 columns, four k16 fragments) of this
// thread's warp `warp` (0-3 in its warpgroup) from rows row0 + 16 * warp ..
// of a bf16 (n_rows, n_cols) matrix at `base`; rows at or past n_rows read
// as zero.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const __nv_bfloat16* base,
                                             int row0, int n_rows, int n_cols, int warp,
                                             int lane) {
  const int r0 = row0 + 16 * warp + (lane >> 2), r1 = r0 + 8, t = lane & 3;
  const unsigned int* p0 = reinterpret_cast<const unsigned int*>(base + (size_t)r0 * n_cols);
  const unsigned int* p1 = reinterpret_cast<const unsigned int*>(base + (size_t)r1 * n_cols);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = (kk * 16 + 2 * t) / 2;  // in 32-bit words
    a[kk][0] = r0 < n_rows ? __ldg(p0 + c) : 0u;
    a[kk][1] = r1 < n_rows ? __ldg(p1 + c) : 0u;
    a[kk][2] = r0 < n_rows ? __ldg(p0 + c + 4) : 0u;
    a[kk][3] = r1 < n_rows ? __ldg(p1 + c + 4) : 0u;
  }
}

// Re-pack the k-th k16 slice of a 64 x 64 f32 accumulator (its n8 blocks 2k
// and 2k + 1) as a bf16 A fragment; with `lo`, also the rounding remainder
// bf16(x - bf16(x)), so hi + lo carries x to ~16 significant bits.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[32], int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(d[8 * k + 2 * i], d[8 * k + 2 * i + 1]);
}
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&d)[32], int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = d[8 * k + 2 * i], x1 = d[8 * k + 2 * i + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    lo[i] = pack_bf16(x0 - hf.x, x1 - hf.y);
  }
}

}  // namespace sm90
