// Self-attention over the frame axis of (B, F, S, heads*64) bf16 tensors, for
// Hopper (sm_90a).
//
// Replaces svd_xtend_tpu/ops/pallas/temporal_attention.py::_kernel (the
// FrameAxisAttention self-attention of every TemporalBasicTransformerBlock).
//
// What bounds it on an H100: each (b, s, head) token is an independent F x F
// attention with F <= 32 frames. At F = 14 that is 4*14*14*64 = 50 kFLOP
// against 4*14*64*2 = 7 kB of q/k/v/o, ~7 FLOP/byte: far below the card's
// ~295 FLOP/byte ridge, so device-memory bytes bound it (0.055 ms at the
// UNet's L0, (2, 14, 2560, 320)). The kernel this one replaced ran one warp
// per token on f32 copies in shared memory with scalar FMAs, 14 of 32 lanes
// busy: issue- and latency-bound at 0.336 ms there, 16 % of the bound.
//
// Design:
//   - Persistent blocks walk (sample, kTokens-token block, head) items, the
//     head fastest, so the blocks in flight read neighbouring heads of the
//     same rows. One producer warp keeps a ring of kStages stages filled by
//     TMA, a stage being one item's q, k and v tiles in bf16; kTokens
//     consumer warps each take one token of the stage.
//   - One 4-D tensor map per tensor, over (channels, frames, tokens, batch)
//     with their real strides, box (64 = one head, kFPad frames, kTokens, 1)
//     and the 128-byte swizzle: a token's frames land in consecutive
//     128-byte rows of shared memory (row t * kFPad + f).
//   - Both products on tensor cores, mma.sync m16n8k16 bf16 -> f32, with
//     operands from ldmatrix (wgmma needs 64 rows of one shared B operand;
//     here every token has its own K). For kFPad = 16 (F <= 16): S = Q K^T
//     is 16 x 16 x 64, 8 MMAs; O = P V is 16 x 64 x 16, 8 MMAs, V through
//     ldmatrix.trans. For kFPad = 32 the same per 16 query rows, over 32 keys.
//   - Softmax in registers, f32, exp2 with scale * log2(e) folded in; the
//     row max and sum take two quad shuffles each; keys >= F are -inf. The
//     whole row of <= 32 keys is present, so nothing is rescaled online. P
//     is normalised, then rounded to bf16 (as frame_attention_reference and
//     the JAX _xla_reference round the softmax weights) and fed from the
//     accumulator fragments as the A operand of P V.
//   - O goes over the token's own q rows in shared memory (its q is in
//     registers by then), and one thread stores the stage's tile by TMA.
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.065 ms at L0, 84 % of
// the bound (the mma.sync kernel before it: 0.335); a 4-stage ring measured
// the same (scripts/bench_frame_gn.py on an edited copy).
//
// Traps, and what the design does about them:
//   - Bank conflicts from the box order. In the natural order (channels,
//     tokens, frames) a token's 8 frame rows that one ldmatrix reads would
//     lie kTokens rows apart; under the 128-byte swizzle every kTokens that
//     is a multiple of 8 puts all 8 in one 16-byte bank group, 8-way
//     conflicts. Frames before tokens in the map keeps a token's frames in
//     consecutive rows: each 8-row ldmatrix reads 8 distinct bank groups.
//   - Padded frames. Rows F..kFPad-1 of V multiply P = 0, so stale shared
//     memory there (a NaN or Inf) would poison O. The box reaches past the
//     map's F frames, and TMA fills those rows with zeros; their keys are
//     masked in the scores as well.
//   - Token tails (S = 40 at the UNet's L3, 50 in the card tests): the last
//     block of a sample reads zeros past S by TMA's out-of-bounds fill, its
//     warps past S skip their token, and the TMA store clips the box at F
//     frames and S tokens.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kHd = 64;
constexpr uint32_t kRowBytes = kHd * 2;  // one frame of one head: a 128-byte swizzle row

// The ring of a block: kStages stages of an item's q, k and v tiles
// (kTokens tokens x kFPad frames x 64 channels each, 1024-byte multiples).
template <int kFPad, int kTokens, int kStages>
struct Smem {
  static constexpr int kElems = kTokens * kFPad * kHd;
  static constexpr uint32_t kTileBytes = kElems * 2;
  static constexpr int kThreads = (kTokens + 1) * 32;  // consumers, then the producer warp
  __nv_bfloat16 q[kStages][kElems];  // o is written over its token's q rows
  __nv_bfloat16 k[kStages][kElems];
  __nv_bfloat16 v[kStages][kElems];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// A 4-D map over a contiguous bf16 (nb, f, s, heads * 64) tensor, in the
// dimension order (channels, frames, tokens, batch), box (64, f_box,
// tokens, 1), 128-byte swizzle; frames past f and tokens past s read as
// zero, and a store clips them.
static inline int encode_frames_map(CUtensorMap* map, const void* base, int nb, int f, int s,
                                    int heads, int f_box, int tokens) {
  const uint64_t token_bytes = (uint64_t)heads * kRowBytes;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || nb < 1 || f < 1 || s < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn fn = sm90::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {(cuuint64_t)heads * kHd, (cuuint64_t)f, (cuuint64_t)s,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {token_bytes * (uint64_t)s, token_bytes,
                                 token_bytes * (uint64_t)s * (uint64_t)f};
  const cuuint32_t box[4] = {kHd, (cuuint32_t)f_box, (cuuint32_t)tokens, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
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

// ---------------------------------------------------------------- device --

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but this thread's newest kPending TMA stores have read their shared memory
template <int kPending>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// the address of the 16-byte chunk `chunk` of row `row` of a 128-byte-swizzled
// tile at the 1024-byte aligned shared address `base`
__device__ __forceinline__ uint32_t sw128(uint32_t base, int row, int chunk) {
  return base + row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One token's attention by one warp: q, k, v at the shared addresses of
// the token's kFPad rows; O is written over the q rows. Fragment layouts
// (m16n8k16): lane = 4g + t holds A rows g and g + 8, columns 2t, 2t + 1
// (+8); B column g, rows 2t, 2t + 1 (+8); C rows g and g + 8, columns 2t,
// 2t + 1. An ldmatrix.x4 lane l addresses row l % 8 of matrix l / 8.
template <int kFPad>
__device__ __forceinline__ void attend(uint32_t q, uint32_t k, uint32_t v, int f,
                                       float scale_log2, int lane) {
  constexpr int kKeyTiles = kFPad / 8;  // n8 tiles of keys in S
  constexpr int kKeySteps = kFPad / 16;  // k16 steps of keys in P V
  const int i = lane & 7, m = lane >> 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kFPad / 16; ++mt) {
    // S = Q K^T over the 64 channels: A = Q rows 16 mt.. (matrices: rows
    // +0 / +8, channel chunks 2 ks / 2 ks + 1); B = K rows (keys) as they
    // lie, two n8 key tiles per ldmatrix
    float s[kKeyTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHd / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sw128(q, 16 * mt + 8 * (m & 1) + i, 2 * ks + (m >> 1)));
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sw128(k, 16 * np + 8 * (m >> 1) + i, 2 * ks + (m & 1)));
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    // softmax of rows g (h = 0) and g + 8 (h = 1); key 8 nt + 2t + j
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = 8 * nt + 2 * t + j < f ? s[nt][2 * h + j] * scale_log2 : -INFINITY;
          s[nt][2 * h + j] = x;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float e = exp2f(s[nt][2 * h + j] - mx);
          s[nt][2 * h + j] = e;
          sum += e;
        }
      const float inv = 1.f / quad_sum(sum);
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[nt][2 * h + j] *= inv;
    }
    // P (normalised, then bf16) as A fragments: keys 16 kk.. = n8 tiles 2kk, 2kk + 1
    uint32_t p[kKeySteps][4];
#pragma unroll
    for (int kk = 0; kk < kKeySteps; ++kk) {
      p[kk][0] = sm90::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = sm90::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = sm90::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = sm90::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    // O = P V: B = V (keys x channels) transposed by ldmatrix.trans, two n8
    // channel tiles per ldmatrix (matrices: keys +0 / +8, chunks 2 dp / 2 dp + 1)
    float o[kHd / 8][4];
#pragma unroll
    for (int nd = 0; nd < kHd / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKeySteps; ++kk)
#pragma unroll
      for (int dp = 0; dp < kHd / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, sw128(v, 16 * kk + 8 * (m & 1) + i, 2 * dp + (m >> 1)));
        mma_bf16(o[2 * dp], p[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], p[kk], b[2], b[3]);
      }
    // O rows 16 mt + g (+8) over the q rows this m tile read above
    __syncwarp();
    const int r0 = 16 * mt + g;
#pragma unroll
    for (int nd = 0; nd < kHd / 8; ++nd) {
      st_shared_b32(sw128(q, r0, nd) + 4 * t, sm90::pack_bf16(o[nd][0], o[nd][1]));
      st_shared_b32(sw128(q, r0 + 8, nd) + 4 * t, sm90::pack_bf16(o[nd][2], o[nd][3]));
    }
  }
}

struct Item {
  int b, blk, h;
};

__device__ __forceinline__ Item item_of(int w, int heads, int n_blk) {
  const int rest = w / heads;
  return Item{rest / n_blk, rest % n_blk, w % heads};
}

template <int kFPad, int kTokens, int kStages>
__global__ void __launch_bounds__(Smem<kFPad, kTokens, kStages>::kThreads, 1)
frame_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, int n_items, int heads,
                       int n_blk, int f, int s, float scale_log2) {
  using Sm = Smem<kFPad, kTokens, kStages>;
  // stores a consumer leaves unread before it frees their stage: one with
  // three stages (the ring keeps one stage loading), none with two
  constexpr int kPending = kStages > 2 ? 1 : 0;
  extern __shared__ char raw[];
  Sm& sm = sm90::aligned_smem<Sm>(raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&sm.full[st], 1);
      sm90::mbar_init(&sm.empty[st], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTokens) {  // the producer warp: one thread issues the loads
    if (lane != 0) return;
    sm90::prefetch_map(&q_map);
    sm90::prefetch_map(&k_map);
    sm90::prefetch_map(&v_map);
    for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
      const int st = it % kStages;
      const Item item = item_of(w, heads, n_blk);
      sm90::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[st], 3 * Sm::kTileBytes);
      tma_load_4d(sm.q[st], &q_map, &sm.full[st], item.h * kHd, 0, item.blk * kTokens, item.b);
      tma_load_4d(sm.k[st], &k_map, &sm.full[st], item.h * kHd, 0, item.blk * kTokens, item.b);
      tma_load_4d(sm.v[st], &v_map, &sm.full[st], item.h * kHd, 0, item.blk * kTokens, item.b);
    }
    return;
  }

  constexpr uint32_t kTokenBytes = kFPad * kRowBytes;
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const int st = it % kStages;
    const Item item = item_of(w, heads, n_blk);
    sm90::mbar_wait(&sm.full[st], (it / kStages) & 1);
    if (item.blk * kTokens + warp < s) {
      const uint32_t off = warp * kTokenBytes;
      attend<kFPad>(sm90::smem_u32(sm.q[st]) + off, sm90::smem_u32(sm.k[st]) + off,
                    sm90::smem_u32(sm.v[st]) + off, f, scale_log2, lane);
    }
    sm90::fence_proxy_async();  // this thread's O writes -> visible to the TMA store
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTokens * 32) : "memory");
    if (threadIdx.x == 0) {
      tma_store_4d(&o_map, sm.q[st], item.h * kHd, 0, item.blk * kTokens, item.b);
      tma_store_wait_read<kPending>();
      if (it >= kPending) sm90::mbar_arrive(&sm.empty[(it - kPending) % kStages]);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int kFPad, int kTokens, int kStages>
int launch(const void* q, const void* k, const void* v, void* o, int nb, int f, int s,
           int heads, float scale, cudaStream_t stream) {
  using Sm = Smem<kFPad, kTokens, kStages>;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_frames_map(&maps[i], bases[i], nb, f, s, heads, kFPad, kTokens);
    if (err) return err;
  }
  constexpr int smem = sm90::smem_bytes<Sm>();
  const auto kernel = frame_attention_kernel<kFPad, kTokens, kStages>;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr != 0) return attr;
  const int n_blk = (s + kTokens - 1) / kTokens;
  const long long n_items = (long long)nb * n_blk * heads;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < sm_count() ? n_items : sm_count());
  kernel<<<grid, Sm::kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                               static_cast<int>(n_items), heads, n_blk, f, s,
                                               scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o: (nb, f, s, heads*64) bf16, contiguous, 16-byte aligned; the plan
// (f_pad frames a token tile, tokens a stage, stages) is frame_plan's of
// ops/kernels/temporal_attention.py, one of those instantiated here, with
// f <= f_pad. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan or geometry it does not take.
extern "C" int svdx_frame_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int nb, int f, int s, int heads, int f_pad, int tokens,
                                        int stages, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f < 1 || f > f_pad) return static_cast<int>(cudaErrorInvalidValue);
  if (f_pad == 16 && tokens == 8 && stages == 3)
    return launch<16, 8, 3>(q, k, v, o, nb, f, s, heads, scale, st);
  if (f_pad == 32 && tokens == 8 && stages == 2)
    return launch<32, 8, 2>(q, k, v, o, nb, f, s, heads, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
