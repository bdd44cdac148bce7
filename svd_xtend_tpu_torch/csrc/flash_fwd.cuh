// The flash-attention forward mainloop for Hopper (sm_90a), shared by the
// packed forward (csrc/flash_attention.cu) and the probe's softmax
// organisations (csrc/flash_variants.cu); they differ only in the softmax
// policy below and in the layout their tensor maps describe. The design and
// its measurements are in the note at the top of flash_attention.cu.
//
// A block is kC consumer warpgroups of 64 query rows each (1, 2 or 3; with
// one, two blocks share an SM; flash_attention.cu picks) and one producer
// warpgroup whose first thread keeps a ring of stages filled by TMA, each
// stage 128 keys of K and of V (two 64-key sub-tiles), and brings each
// item's 64 * kC rows of Q by TMA into one of kQSlots slots. A consumer reads
// its 64 rows of Q from there as the shared-memory A operand of S = Q K^T
// and walks the keys one softmax unit at a time: one 64-key sub-tile, or
// both sub-tiles of a stage where a policy takes its statistics per 128
// keys. Per unit u in the packed forward (the probe's modes take each
// unit's steps in turn, see consume):
//
//   issue S(u) = Q K(u)^T          (wgmma, Q and K from shared memory, K-major)
//   issue O += P(u-1) V(u-1)       (wgmma, P in registers, V MN-major)
//   wait for S(u); softmax of S(u) while P(u-1) V(u-1) runs
//   wait for the product; release the stages of u - 1; O *= alpha(u)
//   P(u) = bf16(S(u)) as A fragments
//
// so the exponentials of one unit run under the tensor cores' work on the
// last one, in one warpgroup, and the second warpgroup's products fill the
// rest.

#pragma once

#include <math.h>

#include "sm90.cuh"

namespace flash_fwd {

constexpr int kD = 64;                         // head dim = one 128-byte TMA box row
constexpr int kSubKeys = 64;                   // keys per sub-tile = one wgmma's N
constexpr int kStageKeys = 2 * kSubKeys;       // keys per ring stage (the probe's major tile)
constexpr int kQSlots = 2;                     // Q tiles in flight: an item's and the next
constexpr uint32_t kStageBytes = kStageKeys * kD * 2;  // one bf16 K or V stage, 16 KB
constexpr float kLog2e = 1.4426950408889634f;

// The shared memory and shape of a block of kC consumer warpgroups. With
// kC = 1 two blocks share an SM, so the ring is 2 stages deep, not 3.
template <int kC>
struct Smem {
  static constexpr int kRows = 64 * kC;               // query rows per block (an item)
  static constexpr int kThreads = 128 * (kC + 1);
  static constexpr int kBlocksPerSm = kC == 1 ? 2 : 1;
  static constexpr int kStages = kC == 1 ? 2 : 3;     // ring depth
  static constexpr uint32_t kQBytes = kRows * kD * 2;  // one item's Q tile
  // registers a thread at launch (the SM's 65536 over its threads, in
  // steps of 8), and the consumers' after setmaxnreg hands them what the
  // producer, down to 24, gives up
  static constexpr int kLaunchRegs = 65536 / (kBlocksPerSm * kThreads) / 8 * 8;
  static constexpr uint32_t kConsumerRegs =
      (kThreads * kLaunchRegs - 128 * 24) / (128 * kC) / 8 * 8;
  __nv_bfloat16 k[kStages][kStageKeys * kD];
  __nv_bfloat16 v[kStages][kStageKeys * kD];
  __nv_bfloat16 q[kQSlots][kRows * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full[kQSlots];
  uint64_t q_empty[kQSlots];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// keeps A fragments that an issued wgmma reads alive (and unwritten) until
// the wait that ends it, as sm90::fence_regs does for accumulators
template <int kN>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// --------------------------------------------------------------- policies --
// A policy holds a consumer thread's row statistics for its two rows (g and
// g + 8 of its warp's 16: accumulator entries i with (i / 2) % 2 = 0 and 1)
// and turns a unit's scores s[kSub][32] (raw Q K^T) in place into the
// weights P, returning the factor alpha by which O is rescaled. kMasked
// sets the scores of keys >= s_kv to -inf first (only the last unit).

// The main forward: statistics per 64-key sub-tile in base 2, scale * log2e
// folded into one FFMA per score (so the scale must be positive: the row
// maximum is taken on the raw scores), ex2.approx. l is this thread's
// partial row sum; the quad's four are added once at the end.
struct OnlineExp2 {
  static constexpr int kSub = 1;
  static constexpr bool kRescale = true;
  float m[2], l[2];
  float c;  // scale * log2(e)

  __device__ explicit OnlineExp2(float scale_log2) : c(scale_log2) {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  template <bool kMasked>
  __device__ __forceinline__ void update(float (&s)[1][32], float (&alpha)[2], int kv0,
                                         int s_kv, int t) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (kMasked && kv0 + 8 * (i / 4) + 2 * t + (i & 1) >= s_kv) s[0][i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[0][i]);
    }
    float mc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = quad_max(mx[j]);
      alpha[j] = ex2((m[j] - mx[j]) * c);
      m[j] = mx[j];
      mc[j] = mx[j] * c;
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      s[0][i] = ex2(fmaf(s[0][i], c, -mc[j]));
      l[j] += s[0][i];
    }
  }
};

// The probe's base and major: x = s * scale, the statistics over kSubT
// sub-tiles (1: per 64-key sub-tile; 2: per 128-key major tile), and the
// exponential of kExp2 ? exp2f (log2e already in the scale) : the accurate
// expf. No mask: the probe's sequences are multiples of 128.
template <int kSubT, bool kExp2>
struct OnlineVariant {
  static constexpr int kSub = kSubT;
  static constexpr bool kRescale = true;
  float m[2], l[2];
  float scale;

  __device__ explicit OnlineVariant(float sc) : scale(sc) {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ static float e(float x) { return kExp2 ? exp2f(x) : expf(x); }

  template <bool kMasked>
  __device__ __forceinline__ void update(float (&s)[kSub][32], float (&alpha)[2], int, int,
                                         int) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int h = 0; h < kSub; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[h][i] *= scale;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[h][i]);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = quad_max(mx[j]);
      alpha[j] = e(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int h = 0; h < kSub; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = (i >> 1) & 1;
        s[h][i] = e(s[h][i] - mx[j]);
        l[j] += s[h][i];
      }
  }
};

// The probe's nosoftmax: p = s * scale, l = sum p, no exponential and no
// rescale, per 128-key major tile.
struct NoSoftmax {
  static constexpr int kSub = 2;
  static constexpr bool kRescale = false;
  float l[2];
  float scale;

  __device__ explicit NoSoftmax(float sc) : scale(sc) { l[0] = l[1] = 0.f; }

  template <bool kMasked>
  __device__ __forceinline__ void update(float (&s)[2][32], float (&)[2], int, int, int) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[h][i] *= scale;
        l[(i >> 1) & 1] += s[h][i];
      }
  }
};

// ------------------------------------------------------------ work items --

// A block is persistent: it takes the work items w = blockIdx.x,
// blockIdx.x + gridDim.x, ... of n_items = n_qt * heads * batch, each 128
// query rows (tile qt) of one (head, sample), neighbouring items sharing a
// head's K and V in L2. Producer and consumers walk the same items, so the
// ring's stage counter runs on from one item to the next and the producer
// fills the next item's first stages while the consumers finish this one.
struct Item {
  int qt, h, b;
};

__device__ __forceinline__ Item item_of(int w, int n_qt, int heads) {
  const int rest = w / n_qt;
  return {w % n_qt, rest % heads, rest / heads};
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

// the grid of a persistent launch: as many blocks as the SMs hold at once
// (blocks_per_sm each: the launch bound's registers allow no more), or
// fewer where there are fewer items
static inline int persistent_blocks(int n_items, int blocks_per_sm) {
  const int slots = sm_count() * blocks_per_sm;
  return n_items < slots ? n_items : slots;
}

// --------------------------------------------------------------- producer --

// The producer thread: for each of the block's items, its rows of Q into
// the item's Q slot (kQSlots in turn), then the n_stages stages of keys 0..
// of its head (columns h * 64) and sample, each into the next free ring
// slot.
template <int kC>
__device__ __forceinline__ void produce(Smem<kC>& sm, const CUtensorMap* q_map,
                                        const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        int n_items, int n_qt, int heads, int n_stages) {
  sm90::prefetch_map(q_map);
  sm90::prefetch_map(k_map);
  sm90::prefetch_map(v_map);
  int it = 0;
  for (int w = blockIdx.x, ii = 0; w < n_items; w += gridDim.x, ++ii) {
    const Item item = item_of(w, n_qt, heads);
    const int qs = ii % kQSlots;
    sm90::mbar_wait(&sm.q_empty[qs], ((ii / kQSlots) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&sm.q_full[qs], Smem<kC>::kQBytes);
    sm90::tma_load_3d(sm.q[qs], q_map, &sm.q_full[qs], item.h * kD,
                      item.qt * Smem<kC>::kRows, item.b);
    for (int j = 0; j < n_stages; ++j, ++it) {
      const int st = it % Smem<kC>::kStages;
      sm90::mbar_wait(&sm.empty[st], ((it / Smem<kC>::kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[st], 2 * kStageBytes);
      sm90::tma_load_3d(sm.k[st], k_map, &sm.full[st], item.h * kD, j * kStageKeys, item.b);
      sm90::tma_load_3d(sm.v[st], v_map, &sm.full[st], item.h * kD, j * kStageKeys, item.b);
    }
  }
}

// ---------------------------------------------------------------- consumer --

// The wgmma descriptor of consumer warpgroup wg's 64 rows of the ii-th
// item's Q tile, once TMA has brought it; free_q hands the slot back after
// the item's last product.
template <int kC>
__device__ __forceinline__ uint64_t wait_q(Smem<kC>& sm, int ii, int wg) {
  sm90::mbar_wait(&sm.q_full[ii % kQSlots], (ii / kQSlots) & 1);
  return sm90::sw128_desc(sm.q[ii % kQSlots] + wg * 64 * kD);
}

template <int kC>
__device__ __forceinline__ void free_q(Smem<kC>& sm, int ii, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&sm.q_empty[ii % kQSlots]);
}

// A consumer warpgroup's key loop over one item: o (64 rows x 64 f32, this
// thread's entries) = sum over keys of P V, unnormalised, with the policy's
// statistics in `pol`. qd: the descriptor of its 64 Q rows; it0: the ring
// stages the block's earlier items used. Sub-tile g of the keys is in
// stage it0 + g / 2 of the ring, its half g % 2. A policy with kSub = 2
// needs s_kv to be a multiple of 128.
//
// kOverlap (the packed forward): S of unit u and P V of unit u - 1 are
// issued together and the softmax of u runs while the second is on the
// tensor cores. Without it (the probe's modes) each unit waits for its
// scores, runs its softmax, then issues and waits for its P V: for the
// major policies' 128-key units the overlap was slower (flash_variants.cu).
template <bool kOverlap, class Policy, int kC>
__device__ __forceinline__ void consume(Smem<kC>& sm, uint64_t qd, float (&o)[32], Policy& pol,
                                        int s_kv, int lane, int it0) {
  constexpr int kSub = Policy::kSub;
  constexpr int kStages = Smem<kC>::kStages;
  const int t = lane & 3;
  const int n_sub = (s_kv + kSubKeys - 1) / kSubKeys;
  const int n_units = (n_sub + kSub - 1) / kSub;
  float s[kSub][32];
  uint32_t p[4 * kSub][4];
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  auto stage_of = [&](int g) { return (it0 + (g >> 1)) % kStages; };
  auto issue_s = [&](int u) {
#pragma unroll
    for (int h = 0; h < kSub; ++h) {
      const int g = u * kSub + h;
      const uint64_t kd = sm90::sw128_desc(sm.k[stage_of(g)] + (g & 1) * kSubKeys * kD);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_ss<0, 0>(s[h], sm90::kmajor_slice(qd, kk), sm90::kmajor_slice(kd, kk),
                             kk > 0);
    }
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int u) {
#pragma unroll
    for (int h = 0; h < kSub; ++h) {
      const int g = u * kSub + h;
      const uint64_t vd = sm90::sw128_desc(sm.v[stage_of(g)] + (g & 1) * kSubKeys * kD);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs<1>(o, p[4 * h + kk], sm90::mnmajor_slice(vd, kk), 1);
    }
    sm90::wgmma_commit();
  };
  auto wait_full = [&](int u) {
#pragma unroll
    for (int h = 0; h < kSub; ++h) {
      const int g = u * kSub + h;
      if (h == 0 || (g & 1) == 0)
        sm90::mbar_wait(&sm.full[stage_of(g)], ((it0 + (g >> 1)) / kStages) & 1);
    }
  };
  // after unit u's P V: one arrival per warp on each stage whose last
  // sub-tile was in u
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < kSub; ++h) {
        const int g = u * kSub + h;
        if ((g & 1) || g == n_sub - 1) sm90::mbar_arrive(&sm.empty[stage_of(g)]);
      }
    }
  };
  auto softmax = [&](int u) {
    const int kv0 = u * kSub * kSubKeys;
    if (kv0 + kSub * kSubKeys <= s_kv)
      pol.template update<false>(s, alpha, kv0, s_kv, t);
    else
      pol.template update<true>(s, alpha, kv0, s_kv, t);
  };
  auto rescale = [&]() {
    if (Policy::kRescale) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
  };
  auto to_frags = [&]() {
#pragma unroll
    for (int h = 0; h < kSub; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(p[4 * h + kk], s[h], kk);
  };
  auto fence_s = [&]() {
#pragma unroll
    for (int h = 0; h < kSub; ++h) sm90::fence_regs(s[h]);
  };

  if constexpr (kOverlap) {
    wait_full(0);
    sm90::wgmma_fence();
    fence_s();
    issue_s(0);
    sm90::wgmma_wait<0>();
    fence_s();
    softmax(0);
    to_frags();
    for (int u = 1; u < n_units; ++u) {
      wait_full(u);
      sm90::wgmma_fence();
      fence_s();
      sm90::fence_regs(o);
      fence_frags(p);
      issue_s(u);
      issue_pv(u - 1);
      sm90::wgmma_wait<1>();
      fence_s();
      softmax(u);
      fence_s();  // the softmax stays ahead of the wait below
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      fence_frags(p);
      release(u - 1);
      rescale();
      to_frags();
    }
    sm90::wgmma_fence();
    sm90::fence_regs(o);
    fence_frags(p);
    issue_pv(n_units - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    fence_frags(p);
    release(n_units - 1);
  } else {
    for (int u = 0; u < n_units; ++u) {
      wait_full(u);
      sm90::wgmma_fence();
      fence_s();
      issue_s(u);
      sm90::wgmma_wait<0>();
      fence_s();
      softmax(u);
      rescale();  // the first unit's alpha is 0 and O still 0
      to_frags();
      sm90::wgmma_fence();
      sm90::fence_regs(o);
      issue_pv(u);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      release(u);
    }
  }
}

// rows r0 and r0 + 8 of this thread's 64 x 64 accumulator, times inv[0] and
// inv[1], as bf16 into a (rows, n_cols) matrix at `base`; rows >= n_rows are
// not stored
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&o)[32],
                                           const float (&inv)[2], int r0, int n_rows,
                                           int n_cols, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)r0 * n_cols + c) =
          sm90::pack_bf16(o[4 * n] * inv[0], o[4 * n + 1] * inv[0]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)(r0 + 8) * n_cols + c) =
          sm90::pack_bf16(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1]);
  }
}

// The barrier set-up every forward kernel starts with (thread 0, then the
// whole block).
template <int kC>
__device__ __forceinline__ void init_barriers(Smem<kC>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Smem<kC>::kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], 4 * kC);  // one arrival per consumer warp
    }
    for (int s = 0; s < kQSlots; ++s) {
      sm90::mbar_init(&sm.q_full[s], 1);
      sm90::mbar_init(&sm.q_empty[s], 4 * kC);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

}  // namespace flash_fwd
