// Non-causal flash attention backward on the packed (B, S, H*64) layout:
// the dQ kernel and the dK/dV kernel, for Hopper (sm_90a).
//
// Replaces svd_xtend_tpu/ops/pallas/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (reached from _bwd_impl; the TPU path transposes to
// head-major around them, these read the packed layout in place). The FA-2
// split into two kernels is kept, as in the JAX package: each output tile
// is owned by one block, so there are no atomics and two runs give the same
// bits.
//
//   P = exp(S*scale - LSE), dP = dO V^T, dS = P * (dP - delta) * scale,
//   dQ = dS K, dK = dS^T Q, dV = P^T dO, delta = rowsum(dO * O)
//   (f32, computed by the wrapper, as the JAX package does outside its
//   kernels).
//
// What bounds it on an H100: per (batch, head) the pair does 7 products of
// S x S x 64 (dQ kernel: S, dP, dQ; dK/dV kernel: S^T, dP^T, dV, dK) against
// ~S*64*2 bytes of each of q, k, v, dO and the three gradients: ~S/2 FLOP per
// byte at head_dim 64, far above the card's ~295 FLOP/byte ridge, so the
// tensor cores bound it. Second come the exp2 (16 per clock per SM: 1 per
// 512 FLOP of the dQ kernel's products) and the f32 work of dS, which sit
// between a warpgroup's products.
//
// Design:
//   - One block = 3 warpgroups: two consumer warpgroups of 64 rows each, so
//     128 query rows (dQ) or 128 keys (dK/dV) per block, and one producer
//     warpgroup whose first warp keeps a ring of kStages shared-memory
//     stages filled. It hands its registers over with setmaxnreg (24 / 240);
//     ptxas still keeps the consumers within the 168 of the 384-thread
//     launch bound (cuobjdump: no register above R165), which is what
//     decides the designs below.
//   - TMA brings each 64-row tile (K and V for dQ; Q and dO for dK/dV) with
//     one 3-D tensor map per operand over (H*64 columns, S rows, B): a box
//     is one head's 64 columns = 128 bytes = one 128-byte swizzle atom, and
//     rows past S read as zero within each sample. Full/empty mbarriers per
//     stage; the dK/dV producer warp also copies the tile's 64 LSE (as
//     base-2) and delta * scale values into the stage with plain loads (a
//     1-D bulk copy would need 16-byte-aligned rows of S floats, which S = 1
//     or 40 do not all give).
//   - Every product is a wgmma m64n64k16, bf16 in, f32 accumulate. The
//     operands that stay for the whole loop are A: Q and dO as register
//     fragments in the dQ kernel; K and V as TMA tiles in shared memory in
//     the dK/dV kernel, whose accumulators (dK, dV) leave no room for them
//     in registers (as fragments they spilled 112 bytes: 1.010-1.017 ms at
//     L0; from shared memory 0.731-0.745 in later calls). P, P^T, dS and
//     dS^T go from the accumulator registers straight into the A fragments
//     of the next wgmma. B is always the swizzled tile as TMA wrote it:
//     K-major for S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T, and
//     MN-major (the transpose bit) for dQ += dS K, dV += P^T dO,
//     dK += dS^T Q. No thread writes a transposed copy.
//   - dS enters dQ and dK as two bf16 terms, hi = bf16(dS) and lo =
//     bf16(dS - hi) (one more wgmma each). One bf16 rounding of dS, as the
//     TPU kernel does, makes the pair 0.23 ms faster at L0 but puts the
//     error up to 2.04x the plain bf16 gradient's (seeds 1-4 at the card
//     tests' and the train step's shapes), above the 1.5x the card tests and
//     chip_smoke hold the kernels to; with the split it is at most 1.15x
//     (the same seeds and shapes; 1.0x at 34 of 40, and within 4.4e-7 of
//     the exact zero at S = 1). P enters dV rounded once.
//   - dS costs ~7 instructions per score: exp2 is one ex2.approx.ftz,
//     delta comes pre-scaled, and only the last, partial tile is masked
//     (P = 0 past S). Against libm exp2f, unscaled delta and a mask on every
//     tile this took 0.13 ms off dQ's 0.60 and 0.16 off dK/dV's 0.74 at L0:
//     the f32 work between a warpgroup's products is what the tensor cores
//     wait on. Rows of a block past S are computed on zeros, not stored.
//
// Tried and refuted (NVIDIA H100 80GB HBM3, 700.00 W, L0 = (14, 2560, 5),
// CUDA events over the wrappers, each variant built from a copy of this
// file with the change made; before the leaner dS): pipelining dQ two tiles
// deep (S and dP of tile i + 1 issued before dS of tile i) needs ~200
// registers, spilled 540 bytes under the 168 and ran 0.807-0.827 ms
// against 0.598-0.603; splitting a tile's wait so P is
// computed while dP runs made ptxas serialise the wgmmas (C7515) and ran
// dQ 0.619 / dK/dV 0.744-0.747 against 0.598-0.600 / 0.731-0.739; 2 or 4
// stages instead of 3: dQ -1 %, dK/dV +2 to +4 %; a 288-thread block (one
// producer warp, no setmaxnreg) compiled to the same 168 registers and ran
// within 2 %. After it: deferring each tile's last wait to the next tile
// (tile i's dQ, or dV and dK, products running on behind tile i + 1's first
// products) made ptxas serialise the wgmmas (C7512, C7515): dQ 0.560 /
// dK/dV 0.712-0.715 ms against 0.455-0.456 / 0.565-0.571 (device time in a
// CUDA graph). Last (chip_smoke.py, device time): a consumer warpgroup with
// no row below S skipping its products and only releasing the stages (the
// second warpgroup of every block at S = 40) took dK/dV at 40 tokens from
// 0.0119-0.0120 to 0.0103-0.0104 ms, but the early exit cost the steady
// state: at L0 0.652-0.665 against 0.578-0.580, dQ unchanged; issuing the
// dK/dV tile's TMA before its LSE/delta copy as well read the same.

#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 64;                           // head dim = one 128-byte TMA box row
constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kBlockRows = 64 * kConsumers;      // queries (dQ) or keys (dK/dV) per block
constexpr int kTile = 64;                        // keys (dQ) or queries (dK/dV) per stage
constexpr int kStages = 3;                       // ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kTile * kD * 2;  // one bf16 tile, 8 KB
constexpr float kLog2e = 1.4426950408889634f;

struct DqSmem {
  __nv_bfloat16 k[kStages][kTile * kD];
  __nv_bfloat16 v[kStages][kTile * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

struct DkvSmem {
  __nv_bfloat16 k[kConsumers][64 * kD];  // the block's keys: 64 per consumer warpgroup
  __nv_bfloat16 v[kConsumers][64 * kD];
  __nv_bfloat16 q[kStages][kTile * kD];
  __nv_bfloat16 dout[kStages][kTile * kD];
  float l2[kStages][kTile];  // LSE * log2(e) of the tile's queries
  float dls[kStages][kTile];  // delta * scale of the tile's queries
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full;
};

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dQ kernel: dS in place of S, rows fixed per thread (l2 = base-2 LSE, dls =
// delta * scale of rows g and g + 8), columns = keys kv0..; kMasked zeroes
// P at keys >= s_kv (the last, partial tile only)
template <bool kMasked>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32],
                                        const float (&l2)[2], const float (&dls)[2],
                                        float scale_log2, float scale, int kv0, int s_kv,
                                        int t) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = (i >> 1) & 1;
    float x = s[i] * scale_log2 - l2[j];
    if (kMasked && kv0 + 8 * (i / 4) + 2 * t + (i & 1) >= s_kv) x = -INFINITY;
    s[i] = ex2(x) * fmaf(dp[i], scale, -dls[j]);
  }
}

// dK/dV kernel: P^T in place of S^T and dS^T in place of dP^T, columns =
// queries q0.. with their base-2 LSE (l2s) and delta * scale (dls) from the
// stage; kMasked zeroes P at queries >= s_q
template <bool kMasked>
__device__ __forceinline__ void ds_cols(float (&s)[32], float (&dp)[32], const float* l2s,
                                        const float* dls, float scale_log2, float scale,
                                        int q0, int s_q, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(l2s + col);
    const float2 dl = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = 4 * n + jj;
      float x = s[i] * scale_log2 - ((jj & 1) ? l2.y : l2.x);
      if (kMasked && q0 + col + (jj & 1) >= s_q) x = -INFINITY;
      s[i] = ex2(x);
      dp[i] = s[i] * fmaf(dp[i], scale, -((jj & 1) ? dl.y : dl.x));
    }
  }
}

// rows row0 and row0 + 8 of a 64 x 64 accumulator (this thread's), as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&acc)[32], int r0,
                                           int n_rows, int n_cols, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)r0 * n_cols + c) =
          sm90::pack_bf16(acc[4 * n], acc[4 * n + 1]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)(r0 + 8) * n_cols + c) =
          sm90::pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// One block per (128-query tile, head, batch): the consumers loop over the
// key tiles of the ring, each warpgroup owning 64 query rows and their dQ.
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int s_q, int s_kv, int n_cols,
                    float scale, float scale_log2) {
  extern __shared__ char smem_raw[];
  DqSmem& sm = sm90::aligned_smem<DqSmem>(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n_tiles = (s_kv + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x % 128 == 0) {
      sm90::prefetch_map(&k_map);
      sm90::prefetch_map(&v_map);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        sm90::tma_load_3d(sm.k[st], &k_map, &sm.full[st], h * kD, it * kTile, b);
        sm90::tma_load_3d(sm.v[st], &v_map, &sm.full[st], h * kD, it * kTile, b);
      }
    }
  } else {  // consumers
    sm90::setmaxnreg_inc<240>();
    const int t = lane & 3;
    const int row0 = blockIdx.x * kBlockRows + wg * 64;
    const size_t qoff = (size_t)b * s_q * n_cols + (size_t)h * kD;
    const float* lse_b = lse + ((size_t)b * gridDim.y + h) * s_q;
    const float* delta_b = delta + ((size_t)b * gridDim.y + h) * s_q;
    uint32_t qa[4][4], da[4][4];
    sm90::load_a_frags(qa, q + qoff, row0, s_q, n_cols, warp, lane);
    sm90::load_a_frags(da, dout + qoff, row0, s_q, n_cols, warp, lane);
    const int r0 = row0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
    // base-2 LSE and delta * scale of this thread's two rows
    const float l2[2] = {r0 < s_q ? lse_b[r0] * kLog2e : 0.f,
                         r1 < s_q ? lse_b[r1] * kLog2e : 0.f};
    const float dls[2] = {r0 < s_q ? delta_b[r0] * scale : 0.f,
                          r1 < s_q ? delta_b[r1] * scale : 0.f};

    float acc[32], s[32], dp[32];
    zero(acc);
    zero(s);
    zero(dp);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      sm90::mbar_wait(&sm.full[st], (it / kStages) & 1);
      const uint64_t kd = sm90::sw128_desc(sm.k[st]), vd = sm90::sw128_desc(sm.v[st]);

      // S = Q K^T, dP = dO V^T (64 rows x 64 keys each)
      sm90::wgmma_fence();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<0>(s, qa[kk], sm90::kmajor_slice(kd, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<0>(dp, da[kk], sm90::kmajor_slice(vd, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // dS, in place of S
      const int kv0 = it * kTile;
      if (kv0 + kTile <= s_kv)
        ds_rows<false>(s, dp, l2, dls, scale_log2, scale, kv0, s_kv, t);
      else
        ds_rows<true>(s, dp, l2, dls, scale_log2, scale, kv0, s_kv, t);
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a_split(hi[kk], lo[kk], s, kk);

      // dQ += dS K: the same K tile, read MN-major
      sm90::wgmma_fence();
      sm90::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs<1>(acc, hi[kk], sm90::mnmajor_slice(kd, kk), 1);
        sm90::wgmma_rs<1>(acc, lo[kk], sm90::mnmajor_slice(kd, kk), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[st]);
    }
    store_rows(dq + qoff, acc, r0, s_q, n_cols, t);
  }
}

// One block per (128-key tile, head, batch): the consumers loop over the
// query tiles of the ring, each warpgroup owning 64 keys and their dK, dV,
// and computing the transposed problem (S^T = K Q^T, dP^T = V dO^T).
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int s_q, int s_kv, int n_cols, float scale, float scale_log2) {
  extern __shared__ char smem_raw[];
  DkvSmem& sm = sm90::aligned_smem<DkvSmem>(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int n_tiles = (s_q + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      sm90::mbar_init(&sm.empty[s], 4 * kConsumers);
    }
    sm90::mbar_init(&sm.kv_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (warp == 0) {
      const float* lse_b = lse + ((size_t)b * gridDim.y + h) * s_q;
      const float* delta_b = delta + ((size_t)b * gridDim.y + h) * s_q;
      if (lane == 0) {
        sm90::prefetch_map(&q_map);
        sm90::prefetch_map(&do_map);
        // the block's K and V tiles, once: the A operands of S^T and dP^T
        sm90::mbar_arrive_expect_tx(&sm.kv_full, 4 * kTileBytes);
        for (int c = 0; c < kConsumers; ++c) {
          const int row = blockIdx.x * kBlockRows + c * 64;
          sm90::tma_load_3d(sm.k[c], &k_map, &sm.kv_full, h * kD, row, b);
          sm90::tma_load_3d(sm.v[c], &v_map, &sm.kv_full, h * kD, row, b);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = half * 32 + lane, row = it * kTile + col;
          sm.l2[st][col] = row < s_q ? lse_b[row] * kLog2e : 0.f;
          sm.dls[st][col] = row < s_q ? delta_b[row] * scale : 0.f;
        }
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
          sm90::tma_load_3d(sm.q[st], &q_map, &sm.full[st], h * kD, it * kTile, b);
          sm90::tma_load_3d(sm.dout[st], &do_map, &sm.full[st], h * kD, it * kTile, b);
        } else {
          sm90::mbar_arrive(&sm.full[st]);
        }
      }
    }
  } else {  // consumers
    sm90::setmaxnreg_inc<240>();
    const int t = lane & 3;
    const int row0 = blockIdx.x * kBlockRows + wg * 64;
    const size_t kvoff = (size_t)b * s_kv * n_cols + (size_t)h * kD;
    const int r0 = row0 + 16 * warp + (lane >> 2);
    sm90::mbar_wait(&sm.kv_full, 0);
    const uint64_t kd = sm90::sw128_desc(sm.k[wg]), vd = sm90::sw128_desc(sm.v[wg]);

    float dka[32], dva[32], s[32], dp[32];
    zero(dka);
    zero(dva);
    zero(s);
    zero(dp);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      sm90::mbar_wait(&sm.full[st], (it / kStages) & 1);
      const uint64_t qd = sm90::sw128_desc(sm.q[st]), od = sm90::sw128_desc(sm.dout[st]);

      // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 queries each)
      sm90::wgmma_fence();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<0, 0>(s, sm90::kmajor_slice(kd, kk), sm90::kmajor_slice(qd, kk),
                             kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<0, 0>(dp, sm90::kmajor_slice(vd, kk), sm90::kmajor_slice(od, kk),
                             kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // P^T in place of S^T, dS^T in place of dP^T; columns are queries
      const int q0 = it * kTile;
      if (q0 + kTile <= s_q)
        ds_cols<false>(s, dp, sm.l2[st], sm.dls[st], scale_log2, scale, q0, s_q, t);
      else
        ds_cols<true>(s, dp, sm.l2[st], sm.dls[st], scale_log2, scale, q0, s_q, t);
      // dV += P^T dO, then dK += dS^T Q: the dO and Q tiles read MN-major;
      // each operand is packed just before its products are issued
      uint32_t pa[4][4], hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(pa[kk], s, kk);
      sm90::wgmma_fence();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<1>(dva, pa[kk], sm90::mnmajor_slice(od, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a_split(hi[kk], lo[kk], dp, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_rs<1>(dka, hi[kk], sm90::mnmajor_slice(qd, kk), 1);
        sm90::wgmma_rs<1>(dka, lo[kk], sm90::mnmajor_slice(qd, kk), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[st]);
    }
    store_rows(dk + kvoff, dka, r0, s_kv, n_cols, t);
    store_rows(dv + kvoff, dva, r0, s_kv, n_cols, t);
  }
}

}  // namespace

// q, k, v, dout: bf16 (b, s, heads*64), contiguous, 16-byte aligned; lse and
// delta f32 (b, heads, s_q); dq like q. Returns the tensor-map encoder's
// refusal (cudaErrorInvalidValue) without launching, or cudaGetLastError()
// after the launch.
extern "C" int svdx_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int b, int s_q,
                                           int s_kv, int heads, float scale, void* stream) {
  const int n_cols = heads * kD;
  CUtensorMap k_map, v_map;
  int err = sm90::encode_rows_map(&k_map, k, n_cols, s_kv, b, kTile);
  if (err == 0) err = sm90::encode_rows_map(&v_map, v, n_cols, s_kv, b, kTile);
  if (err != 0) return err;
  constexpr int smem = sm90::smem_bytes<DqSmem>();
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr != 0) return attr;
  const dim3 grid((s_q + kBlockRows - 1) / kBlockRows, heads, b);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), s_q, s_kv, n_cols,
      scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv like k, v.
extern "C" int svdx_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int b,
                                            int s_q, int s_kv, int heads, float scale,
                                            void* stream) {
  const int n_cols = heads * kD;
  CUtensorMap q_map, do_map, k_map, v_map;
  int err = sm90::encode_rows_map(&q_map, q, n_cols, s_q, b, kTile);
  if (err == 0) err = sm90::encode_rows_map(&do_map, dout, n_cols, s_q, b, kTile);
  if (err == 0) err = sm90::encode_rows_map(&k_map, k, n_cols, s_kv, b, 64);
  if (err == 0) err = sm90::encode_rows_map(&v_map, v, n_cols, s_kv, b, 64);
  if (err != 0) return err;
  constexpr int smem = sm90::smem_bytes<DkvSmem>();
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr != 0) return attr;
  const dim3 grid((s_kv + kBlockRows - 1) / kBlockRows, heads, b);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q_map, do_map, k_map, v_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s_q, s_kv, n_cols, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
